"""The port's topology presets, cost model and HBM path plans against the
reference's: ``topology.presets``, ``topology.cost`` and
``kernels.collectives.plan``, equal on the same inputs (exact floats),
raising the same exception types with the same messages."""

import dataclasses

import pytest

from repro.kernels.collectives import plan as jplan
from repro.topology import cost as jcost
from repro.topology import presets as jpresets
from repro_torch.kernels.collectives import plan as tplan
from repro_torch.topology import cost as tcost
from repro_torch.topology import presets as tpresets
from torch_threads import pin_threads  # noqa: F401

NAMES = tuple(jpresets.PRESETS) + ("nowhere",)
PS = (4, 8, 16, 64)
SIZES = (1 << 10, 1 << 14, 16385, 1 << 20, 1 << 26)
#: the H100's HBM rate (NVIDIA data sheet, SXM), for the ``hbm_bw`` checks
H100_HBM_BW = 3.35e12


def _outcome(fn):
    """``("ok", value)`` or ``(exception type name, message)``."""
    try:
        return "ok", fn()
    except Exception as e:      # the outcome under test
        return type(e).__name__, str(e)


def _topo_fields(t):
    return (type(t).__name__, dataclasses.asdict(t))


def test_preset_names_match():
    assert tpresets.PRESETS == jpresets.PRESETS
    assert sorted(tpresets.GROUPED_PRESETS) == \
        sorted(jpresets.GROUPED_PRESETS)


@pytest.mark.parametrize("name", NAMES)
def test_presets_match_for_p_1_to_64(name):
    for p in range(1, 65):
        for fn in ("tier_split", "tier_split_or_none"):
            assert _outcome(lambda: getattr(tpresets, fn)(name, p)) == \
                _outcome(lambda: getattr(jpresets, fn)(name, p)), (fn, p)
        got = _outcome(lambda: tpresets.get_topology(name, p))
        exp = _outcome(lambda: jpresets.get_topology(name, p))
        if got[0] == "ok" and exp[0] == "ok":
            assert _topo_fields(got[1]) == _topo_fields(exp[1]), p
        else:
            assert got == exp, p
    if name == "torus":
        assert str(_outcome(lambda: tpresets.tier_split(name, 8))[1]) \
            .count("'torus'") == 1


def test_torus_dims_match():
    for p in list(range(-1, 70)) + [128, 256, 1024]:
        for nd in (1, 2, 3, 4):
            assert _outcome(lambda: tpresets.torus_dims(p, nd)) == \
                _outcome(lambda: jpresets.torus_dims(p, nd)), (p, nd)


@pytest.mark.parametrize("name", jpresets.PRESETS)
def test_candidates_match(name):
    for coll in jcost.CANDIDATES:
        assert tcost.candidates_for(coll, name) == \
            jcost.candidates_for(coll, name)
        assert tcost.wire_candidates(coll, name) == \
            jcost.wire_candidates(coll, name)
    assert _outcome(lambda: tcost.candidates_for("allreduce", "nowhere")) \
        == _outcome(lambda: jcost.candidates_for("allreduce", "nowhere"))


def test_constants_and_schedule_algos_match():
    for k in ("CANDIDATES", "SMALL_CUTOFF_BYTES", "HBM_BW",
              "UNFUSED_HBM_PASSES", "FUSED_HBM_PASSES",
              "FUSED_STEP_OVERHEAD_S", "CODEC_HBM_PASSES",
              "CODEC_STEP_OVERHEAD_S", "ADAMW_HBM_PASSES",
              "BUCKET_SIZE_CANDIDATES", "BUCKET_SWEEP_TOTAL_BYTES",
              "_SCHED_ALGO", "WIRE_CODEC_COLLECTIVES", "WIRE_CODEC_BACKENDS"):
        assert getattr(tcost, k) == getattr(jcost, k), k
    for (coll, b) in jcost._SCHED_ALGO:
        for n in (16384, 16385):
            assert tcost.schedule_algo(coll, b, n) == \
                jcost.schedule_algo(coll, b, n)
            for algo in ("bine", "bine_small", "recdoub"):
                assert tcost.hbm_passes(b, algo) == jcost.hbm_passes(b, algo)
    assert _outcome(lambda: tcost.schedule_algo("allreduce", "nope", 1)) == \
        _outcome(lambda: jcost.schedule_algo("allreduce", "nope", 1))


@pytest.mark.parametrize("name", jpresets.PRESETS)
def test_predict_time_matches(name):
    for p in PS:
        tj = jpresets.get_topology(name, p)
        tt = tpresets.get_topology(name, p)
        for (coll, b) in jcost._SCHED_ALGO:
            wires = ["float32"]
            if coll in jcost.WIRE_CODEC_COLLECTIVES:
                wires += ["bfloat16", "int8"]
            for n in SIZES:
                for w in wires:
                    exp = _outcome(lambda: jcost.predict_time(
                        coll, b, p, n, tj, wire_dtype=w))
                    got = _outcome(lambda: tcost.predict_time(
                        coll, b, p, n, tt, wire_dtype=w))
                    assert got == exp, (coll, b, p, n, w)
                    if got[0] == "ok":
                        fast = tcost.predict_time(coll, b, p, n, tt,
                                                  wire_dtype=w,
                                                  hbm_bw=H100_HBM_BW)
                        assert fast < got[1], (coll, b, p, n, w)


@pytest.mark.parametrize("name", jpresets.PRESETS)
def test_degrade_topology_matches(name):
    """``degrade_topology`` at p = 4 ... 64: the same degraded fields (the
    global tier of a grouped preset, every link of the torus), the same
    predicted times on them, the same refusal of a speed-up."""
    for p in PS:
        tt = tpresets.get_topology(name, p)
        tj = jpresets.get_topology(name, p)
        for beta, alpha in ((1.0, 1.0), (3.0, 2.0), (0.5, 1.0), (2.0, 0.5)):
            got = _outcome(lambda: tcost.degrade_topology(tt, beta, alpha))
            exp = _outcome(lambda: jcost.degrade_topology(tj, beta, alpha))
            if got[0] != "ok" or exp[0] != "ok":
                assert got == exp, (p, beta, alpha)
                continue
            assert _topo_fields(got[1]) == _topo_fields(exp[1])
            for n in SIZES:
                assert tcost.predict_time("allreduce", "bine", p, n,
                                          got[1]) == \
                    jcost.predict_time("allreduce", "bine", p, n, exp[1])


@pytest.mark.parametrize("name", jpresets.PRESETS)
def test_bucket_sizing_matches(name):
    for p in PS:
        tj = jpresets.get_topology(name, p)
        tt = tpresets.get_topology(name, p)
        for b in jcost.BUCKET_SIZE_CANDIDATES[::2]:
            assert tcost.predict_bucket_time(p, b, 1 << 30, tt) == \
                jcost.predict_bucket_time(p, b, 1 << 30, tj)
        assert tcost.optimal_bucket_bytes(p, tt) == \
            jcost.optimal_bucket_bytes(p, tj)
        assert tcost.optimal_bucket_bytes(p, tt, hbm_bw=H100_HBM_BW) in \
            tcost.BUCKET_SIZE_CANDIDATES


@pytest.mark.parametrize("p", [4, 8, 16])
@pytest.mark.parametrize("algo", jplan.ALGOS)
@pytest.mark.parametrize("coll", jplan.COLLECTIVES)
def test_path_plans_match(coll, algo, p):
    n = p * 96
    for itemsize in (2, 4):
        got = tplan.path_plans(coll, algo, p, n, itemsize)
        exp = jplan.path_plans(coll, algo, p, n, itemsize)
        assert [g.as_dict() for g in got] == [e.as_dict() for e in exp]
        assert tplan.compare(coll, algo, p, n, itemsize) == \
            jplan.compare(coll, algo, p, n, itemsize)
    for wire in ("float32", "bfloat16", "int8"):
        assert tplan.wire_payload_bytes(coll, algo, p, n, wire) == \
            jplan.wire_payload_bytes(coll, algo, p, n, wire)


def test_path_plans_reject_alike():
    for args in (("alltoall", "bine", 4, 64), ("allreduce", "bruck", 4, 64)):
        assert _outcome(lambda: tplan.path_plans(*args)) == \
            _outcome(lambda: jplan.path_plans(*args))
