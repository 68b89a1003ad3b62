"""The port's own copies of the schedules, the schedule tables and the
packaged decision tables equal the JAX package's; so do its decisions
under ``tuning="measured"``, against measured tables the reference's
tuner writes (``tuner.refresh.refresh_table`` over seeded synthetic
timings), and its fallbacks when such a table is missing, stale, truncated
or hand-edited."""

import filecmp
import os

import numpy as np
import pytest

from repro import topology as jtopo
from repro.core import schedules as jsc
from repro.core import tables as jtb
from repro.topology import PRESETS, select_bucket_bytes
from repro_torch import topology as ttopo
from repro_torch.core import schedules as tsc
from repro_torch.core import tables as ttb
from torch_threads import pin_threads  # noqa: F401

PS = [2, 4, 8, 16, 32]
KINDS = ["bine_dd", "recdoub_dd", "bine_dh", "recdoub_dh"]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("kind", KINDS)
def test_butterfly_tables_match(kind, p):
    try:
        exp = jtb.butterfly_tables(kind, p)
    except ValueError as e:          # no future-cone partition (bine_dh)
        with pytest.raises(ValueError, match="future-cone"):
            ttb.butterfly_tables(kind, p)
        assert "future-cone" in str(e)
        return
    got = ttb.butterfly_tables(kind, p)
    assert (got.p, got.s, got.perms) == (exp.p, exp.s, exp.perms)
    for f in ("keep_off", "send_off", "cbit", "final_block", "inv_final"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f),
                                      err_msg=f)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("kind", KINDS)
def test_small_butterfly_perms_match(kind, p):
    assert ttb.small_butterfly_perms(kind, p) == \
        jtb.small_butterfly_perms(kind, p)


def test_bucket_bytes_presets_match():
    assert sorted(ttopo.PRESETS) == sorted(PRESETS)


@pytest.mark.parametrize("topology", sorted(ttopo.PRESETS))
def test_bucket_bytes_copy_matches(topology):
    for p in (2, 3, 4, 6, 8, 12, 16, 32, 64, 128, 256, 1024):
        assert ttopo.select_bucket_bytes(p, topology) == \
            select_bucket_bytes(p, topology), (topology, p)


def test_bucket_bytes_unknown_topology_raises():
    with pytest.raises(ValueError, match="unknown topology"):
        ttopo.select_bucket_bytes(4, "nowhere")


# ---------------------------------------------------------------------------
# Trees, gather/scatter windows, alltoall slots
# ---------------------------------------------------------------------------

TREE_ALGOS = ["bine_dh", "bine_dd", "binomial_dh", "binomial_dd"]
ALLTOALL_ALGOS = ["bine_dd", "recdoub_dd", "bine_dh", "recdoub_dh", "bruck"]


def _roots(p):
    return sorted({0, 1 % p, p - 1})


def _same_fields(got, exp, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(exp, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f
        else:
            assert a == b, f


def _both(fn_j, fn_t, *args):
    """Call both packages' builders: equal results, or the same error."""
    try:
        exp = fn_j(*args)
    except (ValueError, KeyError, AssertionError) as e:
        with pytest.raises(type(e)) as info:
            fn_t(*args)
        assert str(info.value) == str(e)
        return None, None
    return fn_t(*args), exp


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("algo", TREE_ALGOS)
def test_tree_tables_match(algo, p):
    for root in _roots(p):
        got, exp = _both(jtb.tree_tables, ttb.tree_tables, algo, p, root)
        if exp is not None:
            _same_fields(got, exp, ("p", "s", "perms", "recv_step"))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("algo", TREE_ALGOS)
def test_gather_and_scatter_tables_match(algo, p):
    for root in _roots(p):
        got, exp = _both(jtb.gather_tables, ttb.gather_tables, algo, p, root)
        if exp is not None:
            _same_fields(got, exp, (
                "p", "s", "posmap", "anchor", "own_local", "perms", "sizes",
                "recv_off", "recv_mask", "send_mask", "root_unrot"))
        got, exp = _both(jtb.scatter_tables, ttb.scatter_tables, algo, p,
                         root)
        if exp is not None:
            _same_fields(got, exp, (
                "p", "s", "posmap", "root_rot", "perms", "sizes", "send_off",
                "recv_mask", "send_mask", "own_local"))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("algo", ALLTOALL_ALGOS)
def test_alltoall_tables_match(algo, p):
    got, exp = _both(jtb.alltoall_tables, ttb.alltoall_tables, algo, p)
    if exp is not None:
        _same_fields(got, exp, ("p", "s", "perms", "send_slots",
                                "recv_slots", "final_slots", "send_contig"))


def _steps(sched):
    return ([[(m.src, m.dst, m.blocks) for m in step] for step in sched.steps],
            sched.kinds, sched.collective, sched.p, sched.root)


@pytest.mark.parametrize("p", PS + [3, 6, 12])
def test_schedules_match(p):
    """The copied schedule generators give the reference's schedules for
    gather, scatter, alltoall and bruck (and raise where it raises)."""
    calls = [("bruck_alltoall_sched", (p,))]
    for algo in TREE_ALGOS:
        for root in _roots(p):
            calls += [("gather_sched", (algo, p, root)),
                      ("scatter_sched", (algo, p, root))]
    for algo in ("bine_dd", "recdoub_dd", "bine_dh", "recdoub_dh"):
        calls.append(("alltoall_sched", (algo, p)))
    for name, args in calls:
        got, exp = _both(getattr(jsc, name), getattr(tsc, name), *args)
        if exp is not None:
            assert _steps(got) == _steps(exp), (name, args)


# ---------------------------------------------------------------------------
# Decision tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", sorted(PRESETS))
def test_decision_table_files_are_byte_copies(topology):
    assert filecmp.cmp(jtopo.table_path(topology), ttopo.table_path(topology),
                       shallow=False)
    assert os.path.dirname(ttopo.table_path(topology)) != \
        os.path.dirname(jtopo.table_path(topology))


#: sizes on both sides of every bucket edge, and beyond the last
SIZES = sorted({s + d for s in jtopo.SIZE_BUCKETS for d in (-1, 0, 1)}
               | {1, 1 << 30})
TABLE_PS = sorted(set(jtopo.P_GRID) | {3, 6, 12, 200})


@pytest.mark.parametrize("topology", sorted(PRESETS))
@pytest.mark.parametrize("collective", sorted(jtopo.CANDIDATES))
def test_decisions_match(collective, topology):
    for p in TABLE_PS:
        for n in SIZES:
            args = (collective, p, n, topology)
            assert ttopo.select_backend(*args) == \
                jtopo.select_backend(*args), args
            assert ttopo.decision_provenance(*args) == \
                jtopo.decision_provenance(*args), args
            assert ttopo.select_wire(*args) == jtopo.select_wire(*args), args
            assert ttopo.wire_decision_provenance(*args) == \
                jtopo.wire_decision_provenance(*args), args
        assert ttopo.select_bucket_bytes(p, topology) == \
            jtopo.select_bucket_bytes(p, topology), (topology, p)


def test_table_constants_match():
    assert ttopo.P_GRID == jtopo.P_GRID
    assert ttopo.SIZE_BUCKETS == jtopo.SIZE_BUCKETS
    assert ttopo.SMALL_CUTOFF_BYTES == jtopo.SMALL_CUTOFF_BYTES
    assert ttopo.CANDIDATES == jtopo.CANDIDATES
    for topology in PRESETS:
        got, exp = ttopo.load_table(topology), jtopo.load_table(topology)
        for f in ("topology", "small_cutoff_bytes", "ps", "size_buckets",
                  "entries", "bucket_bytes", "provenance", "wire_entries",
                  "wire_provenance"):
            assert getattr(got, f) == getattr(exp, f), (topology, f)


@pytest.fixture
def measured_env(tmp_path, monkeypatch):
    """A fresh measured-table directory and empty table caches and
    warn-once keys in both packages (restored afterwards)."""
    from repro.topology import table as jtable
    from repro_torch.topology import table as ttable
    monkeypatch.setenv("REPRO_MEASURED_TABLE_DIR", str(tmp_path))
    for mod in (jtable, ttable):
        monkeypatch.setattr(mod, "_LOADED", {})
        monkeypatch.setattr(mod, "_WARNED", set())
    return tmp_path


def measured_table(topology: str, seed: int = 0):
    """The reference tuner's measured table for ``topology``: synthetic
    seeded timings covering about half of the (collective, p, bucket)
    cells with every candidate backend, and half of the wire cells with
    every (backend, wire) pair."""
    from repro.topology import cost as jcost
    from repro.tuner.refresh import refresh_table
    from repro.tuner.store import Measurement
    base = jtopo.load_table(topology)
    rng = np.random.RandomState(seed)
    ms = []
    for coll, cands in sorted(jcost.CANDIDATES.items()):
        for p in base.ps:
            for nbytes in base.size_buckets:
                if rng.rand() < 0.5:
                    ms += [Measurement(coll, b, p, nbytes, float(rng.rand()))
                           for b in cands]
                if coll in base.wire_entries and rng.rand() < 0.5:
                    ms += [Measurement(coll, b, p, nbytes, float(rng.rand()),
                                       wire_dtype=w)
                           for b, w in jcost.wire_candidates(coll, topology)]
    return refresh_table(topology, ms)


def _same_decisions(topology, tuning="measured"):
    for collective in sorted(jtopo.CANDIDATES):
        for p in TABLE_PS:
            for n in SIZES:
                args = (collective, p, n, topology)
                kw = dict(tuning=tuning)
                assert ttopo.select_backend(*args, **kw) == \
                    jtopo.select_backend(*args, **kw), args
                assert ttopo.decision_provenance(*args, **kw) == \
                    jtopo.decision_provenance(*args, **kw), args
                assert ttopo.select_wire(*args, **kw) == \
                    jtopo.select_wire(*args, **kw), args
                assert ttopo.wire_decision_provenance(*args, **kw) == \
                    jtopo.wire_decision_provenance(*args, **kw), args
    for p in TABLE_PS:
        assert ttopo.select_bucket_bytes(p, topology, tuning) == \
            jtopo.select_bucket_bytes(p, topology, tuning), (topology, p)


@pytest.mark.parametrize("topology", sorted(PRESETS))
def test_measured_decisions_match_jax(topology, measured_env):
    """Every cell of every preset, with the reference's measured table in
    ``REPRO_MEASURED_TABLE_DIR``: the same backend, wire and provenance,
    and at least one measured cell that overrides the analytic pick."""
    import warnings
    table = measured_table(topology)
    table.save(jtopo.measured_table_path(topology))
    assert ttopo.measured_table_path(topology) == \
        jtopo.measured_table_path(topology)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # a usable table never warns
        _same_decisions(topology)
    flips = [(c, p, i) for c, per_p in table.provenance.items()
             for p, row in per_p.items() for i, src in enumerate(row)
             if src == "measured" and table.entries[c][p][i] !=
             jtopo.load_table(topology).entries[c][p][i]]
    assert flips, "the synthetic timings override no analytic cell"
    c, p, i = flips[0]
    n = table.size_buckets[i]
    assert ttopo.select_backend(c, p, n, topology, tuning="measured") != \
        ttopo.select_backend(c, p, n, topology)


def _corrupt(kind: str, text: str) -> str:
    import json
    if kind == "truncated":
        return text[: len(text) // 2]
    d = json.loads(text)
    if kind == "stale":              # another grid: an older tune run
        d["size_buckets"] = d["size_buckets"][:-1]
    elif kind == "hand_edited":      # a cell off the grid
        d["entries"]["allreduce"]["3"] = d["entries"]["allreduce"]["4"]
        d["provenance"]["allreduce"]["3"] = d["provenance"]["allreduce"]["4"]
    return json.dumps(d)


@pytest.mark.parametrize("kind", ["missing", "stale", "truncated",
                                  "hand_edited"])
def test_measured_fallback_warns_once(kind, measured_env):
    """An unusable measured table warns once per (topology, p, tuning) and
    falls back to the analytic decisions, in both packages alike."""
    import warnings
    topology = "lumi"
    if kind != "missing":
        path = jtopo.measured_table_path(topology)
        measured_table(topology).save(path)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(_corrupt(kind, text))
    match = "no measured table" if kind == "missing" else "unusable"
    with pytest.warns(UserWarning, match=match) as rec:
        got = ttopo.select_backend("allreduce", 8, 1 << 20, topology,
                                   tuning="measured")
    assert len([w for w in rec if match in str(w.message)]) == 1
    assert got == ttopo.select_backend("allreduce", 8, 1 << 20, topology)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ttopo.select_wire("reduce_scatter", 8, 1 << 20, topology,
                          tuning="measured")
    with pytest.warns(UserWarning, match=match):
        _same_decisions(topology)           # the reference warns too
    for p in (8, 64):
        for n in (1 << 10, 1 << 20):
            assert ttopo.decision_provenance(
                "allreduce", p, n, topology, tuning="measured") == "analytic"


def test_invalidate_tables_rewarns_at_a_new_p(measured_env):
    """After ``invalidate_tables`` a lookup at a new rank count (an
    elastic restart) warns again; at the same count it stays quiet."""
    import warnings
    with pytest.warns(UserWarning, match="no measured table"):
        ttopo.select_backend("allreduce", 8, 4096, "lumi", tuning="measured")
    ttopo.invalidate_tables("lumi")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ttopo.select_backend("allreduce", 8, 4096, "lumi", tuning="measured")
    ttopo.invalidate_tables()
    with pytest.warns(UserWarning, match="no measured table") as rec:
        ttopo.select_backend("allreduce", 4, 4096, "lumi", tuning="measured")
    assert "lumi" in str(rec[0].message)
    # a table written after the first lookup is read once invalidated
    measured_table("lumi").save(ttopo.measured_table_path("lumi"))
    assert ttopo.decision_provenance("allgather", 4, 4096, "lumi",
                                     tuning="measured") == "analytic"
    ttopo.invalidate_tables("lumi")
    _same_decisions("lumi")


@pytest.mark.parametrize("wire", ["float32", "auto"])
def test_measured_train_step_buckets_match_jax(wire, measured_env):
    """``make_train_step(..., TrainConfig(backend="auto",
    tuning="measured"))`` resolves its buckets as the reference does, and
    reports the same provenance per bucket."""
    import jax
    from repro.configs import base as jbase
    from repro.models import transformer as JT
    from repro.train import step as jstep
    from repro.train import zero as jzero
    from repro_torch.configs import base as tbase
    from repro_torch.models import transformer as TF
    from repro_torch.train import step as tstep
    topology, p = "tpu_multipod", 4
    measured_table(topology).save(jtopo.measured_table_path(topology))
    jcfg = jbase.reduced(jbase.get_config("phi4-mini-3.8b"))
    jshapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                             jax.random.key(0))
    tcfg = tbase.reduced(tbase.get_config("phi4-mini-3.8b"))
    kw = dict(backend="auto", wire_dtype=wire, topology=topology,
              tuning="measured", bucket_bytes=1 << 12)
    jt, tt = jstep.TrainConfig(**kw), tstep.TrainConfig(**kw)
    jplan = jstep.resolve_bucket_plan(jt, p, jshapes,
                                      jzero.zero_layout(jcfg, jshapes, p))
    _, info, _ = tstep.make_train_step(tcfg, tt, p, TF.param_shapes(tcfg),
                                       "cpu")
    assert info["decisions"] == jstep.bucket_decisions(jt, jplan)
    report = tstep.bucket_report(tt, info["bucket_plan"])
    assert report == jstep.bucket_report(jt, jplan)
    assert any(r["rs_provenance"] == "measured" or
               r["rs_wire_provenance"] == "measured" for r in report)


def test_format_checks_and_measured_tuning(measured_env):
    """Format checks; ``tuning="measured"`` with no measured table is the
    analytic decision (after one warning)."""
    d = {"format": 9, "topology": "x", "small_cutoff_bytes": 1, "ps": [4],
         "size_buckets": [256], "entries": {}}
    with pytest.raises(ValueError, match="unsupported decision-table format"):
        ttopo.DecisionTable.from_json_dict(d)
    d["format"] = 1
    d["entries"] = {"allreduce": {"4": ["bine"]}}
    t = ttopo.DecisionTable.from_json_dict(d)
    assert t.lookup_wire("allreduce", 4, 10) == ("bine", "float32")
    assert t.provenance_of("allreduce", 4, 10) == "analytic"
    with pytest.warns(UserWarning, match="falling back to analytic"):
        assert ttopo.select_backend("allreduce", 4, 10, tuning="measured") \
            == ttopo.select_backend("allreduce", 4, 10)
    with pytest.raises(ValueError, match="unknown tuning"):
        ttopo.select_backend("allreduce", 4, 10, tuning="guess")
