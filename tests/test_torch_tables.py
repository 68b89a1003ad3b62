"""The port's own copies of the schedules, the schedule tables and the
packaged decision tables equal the JAX package's."""

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


def test_format_checks_and_measured_tuning():
    d = {"format": 9, "topology": "x", "small_cutoff_bytes": 1, "ps": [4],
         "size_buckets": [256], "entries": {}}
    with pytest.raises(ValueError, match="unsupported decision-table format"):
        ttopo.DecisionTable.from_json_dict(d)
    d["format"] = 1
    d["entries"] = {"allreduce": {"4": ["bine"]}}
    t = ttopo.DecisionTable.from_json_dict(d)
    assert t.lookup_wire("allreduce", 4, 10) == ("bine", "float32")
    assert t.provenance_of("allreduce", 4, 10) == "analytic"
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        ttopo.select_backend("allreduce", 4, 10, tuning="measured")
