"""The port's obs layer (``repro_torch.obs``, ``repro_torch.tuner.trace``)
against the JAX package's.

  * mirrors of ``tests/obs/test_metrics.py``, ``test_timeline.py`` and
    ``test_collect.py``: the same calls on a registry or a timeline of
    each package give equal snapshots, nearest-rank quantiles, Prometheus
    text and Chrome-trace JSON;
  * ``link_local_bytes`` / ``link_global_bytes`` equal the port's
    ``core.traffic`` closed forms EXACTLY (and the reference's
    attribution) for every registered (collective, algo) pair at p in
    {4, 8}, identity and spread placements, a grouped and a torus preset;
  * the bucket-plan records of the reduced phi4-mini's train step equal
    the reference's ``record_bucket_plan`` for the same plan, on the
    float32, int8 and auto wires.

The API hook (one call of each collective, every backend) is held against
the reference in tests/test_torch_api.py.
"""

import json
import warnings

import numpy as np
import pytest

from repro.obs import collect as jcollect
from repro.obs import metrics as jmetrics
from repro.obs import timeline as jtimeline
from repro.tuner import trace as jtrace
from repro_torch.core import traffic
from repro_torch.core.schedules import COLLECTIVES, get_schedule, list_algos
from repro_torch.obs import collect, metrics, timeline
from repro_torch.obs.metrics import Histogram, Registry
from repro_torch.topology.presets import get_topology
from repro_torch.tuner import trace

PAYLOAD = 1 << 20  # pow2 so every replay term is an exact binary float


@pytest.fixture
def fresh(monkeypatch):
    """Empty, enabled default registries in both packages."""
    regs = (Registry(), jmetrics.Registry())
    for mod, reg in zip((metrics, jmetrics), regs):
        monkeypatch.setattr(mod, "_REGISTRY", reg)
        monkeypatch.setattr(mod, "_ENABLED", True)
    return regs


def _oracle_nearest_rank(xs, q):
    xs = np.sort(np.asarray(xs, dtype=float))
    k = int(np.ceil(q / 100.0 * len(xs))) - 1
    return float(xs[max(0, min(len(xs) - 1, k))])


@pytest.mark.parametrize("n", [1, 2, 3, 10, 101, 997])
def test_quantiles_match_oracle_and_reference(n):
    xs = np.random.RandomState(n).randn(n) * 10.0
    h, j = Histogram(), jmetrics.Histogram()
    for x in xs:
        h.observe(x)
        j.observe(x)
    for q in (0.0, 1.0, 25.0, 50.0, 90.0, 99.0, 100.0):
        assert h.quantile(q) == j.quantile(q) == _oracle_nearest_rank(xs, q)
    assert h.summary() == j.summary()
    assert Histogram().quantile(50) == 0.0 and Histogram().count == 0


def test_quantile_matches_scheduler_pct():
    from repro_torch.serve.scheduler import _pct
    xs = list(np.random.RandomState(0).rand(37) * 100)
    h = Histogram()
    for x in xs:
        h.observe(x)
    for q in (50, 90, 99):
        assert h.quantile(q) == _pct(xs, q)


def _program(reg):
    """The reference tests' calls, on one registry."""
    out = [reg.inc("calls", 1.0, backend="bine"),
           reg.inc("calls", 2.0, backend="bine")]
    reg.inc("calls", 1.0, backend="ring")
    reg.set_gauge("mttr", 4.0)
    reg.set_gauge("mttr", 2.0)
    reg.inc("x", 1.0, a="1", b="2")
    reg.inc("x", 1.0, b="2", a="1")
    with reg.scope(replica="0"):
        reg.inc("ticks")
        with reg.scope(replica="1", phase="drain"):
            reg.inc("ticks")
            reg.observe("lat", 0.5)
        reg.inc("ticks", replica="9")
    for x in np.random.RandomState(1).rand(23):
        reg.observe("lat", x, replica="0")
    reg.inc("c", 1.0, path='a"b\\c')
    for x in (1.0, 2.0, 3.0, 4.0):
        reg.observe("fleet_tick_seconds", x, replica="0")
    out += [reg.counter_value("calls", backend="nope"),
            reg.gauge_value("mttr"), reg.gauge_value("missing"),
            reg.quantile("lat", 99, replica="0"), reg.series("x"),
            reg.series("ticks")]
    return out


def test_registry_program_matches_reference():
    reg, jreg = Registry(), jmetrics.Registry()
    assert _program(reg) == _program(jreg)
    assert reg.snapshot() == jreg.snapshot()
    back = Registry.from_snapshot(json.loads(json.dumps(reg.snapshot())))
    assert back.snapshot() == reg.snapshot()
    assert timeline.export_prom(reg) == jtimeline.export_prom(jreg)
    assert timeline.export_prom(Registry()) == ""
    lines = timeline.export_prom(reg).splitlines()
    assert 'fleet_tick_seconds_sum{replica="0"} 10' in lines
    reg.reset()
    assert reg.snapshot() == Registry().snapshot()


def test_dump_registry_matches_reference(tmp_path, fresh):
    for reg in fresh:
        _program(reg)
    metrics.dump_registry(str(tmp_path / "p.json"), timestamp="t0")
    jmetrics.dump_registry(str(tmp_path / "j.json"), timestamp="t0")
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()


def test_set_enabled_returns_previous_and_disabled_restores(monkeypatch):
    monkeypatch.setattr(metrics, "_ENABLED", True)
    assert metrics.set_enabled(False) is True
    assert metrics.enabled() is False
    metrics.set_enabled(True)
    with metrics.disabled():
        assert not metrics.enabled()
    assert metrics.enabled()


def test_repro_obs_env_starts_disabled(subproc):
    out = subproc("import os; os.environ['REPRO_OBS'] = '0'\n"
                  "from repro_torch.obs import metrics\n"
                  "print('ENABLED', metrics.enabled())", devices=1,
                  timeout=120)
    assert "ENABLED False" in out


def _sample(mod):
    tl = mod.Timeline()
    t0 = 1.7e15
    tl.span("train_step", "train", t0, 1500.0, step=0, loss=2.5)
    tl.span("train_step", "train", t0 + 2000.0, 1400.0, step=1)
    tl.span("fleet_tick", "fleet", 4.0, 1.0, track="1", latency_s=0.01)
    tl.instant("replica_crash", "fleet", 5.0, track="1")
    tl.instant("chaos_crash", "chaos", 5.0, track="1", magnitude=1.0)
    tl.span("odd", "elsewhere", 7.0, 2.0)
    return tl


def test_chrome_trace_matches_reference(tmp_path, fresh):
    tl, jtl = _sample(timeline), _sample(jtimeline)
    assert timeline.to_chrome_trace(tl) == jtimeline.to_chrome_trace(jtl)
    assert tl.to_json_dict() == jtl.to_json_dict()
    back = timeline.Timeline.from_json_dict(
        json.loads(json.dumps(tl.to_json_dict())))
    assert back.to_json_dict() == tl.to_json_dict()
    timeline.dump_chrome_trace(tl, str(tmp_path / "p.json"))
    jtimeline.dump_chrome_trace(jtl, str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    rows = [r for r in timeline.to_chrome_trace(tl)["traceEvents"]
            if r["name"] == "train_step"]
    assert [r["ts"] for r in rows] == [0.0, 2000.0]
    with metrics.disabled():
        tl.span("train_step", "train", 0.0, 1.0)
        tl.instant("x", "fleet", 0.0)
    assert len(tl) == 6


def _spread(topo, p):
    return tuple(i * topo.group_size for i in range(p))


def _cases():
    for coll in COLLECTIVES:
        for algo in list_algos(coll):
            for p in (4, 8):
                yield coll, algo, p


@pytest.mark.parametrize("coll,algo,p", _cases(), ids=lambda v: str(v))
def test_attribution_matches_traffic_closed_forms(coll, algo, p):
    """Identity and spread placements on a grouped preset, and a torus:
    the replayed (local, global) attribution == the port's ``core.traffic``
    closed forms, exactly, and == the reference's attribution."""
    topo = get_topology("lumi", p)
    sched = get_schedule(coll, algo, p)
    for placement in (None, _spread(topo, p)):
        want_total = traffic.total_bytes(sched, p, float(PAYLOAD))
        want_global = traffic.global_bytes(sched, p, float(PAYLOAD), topo,
                                           placement=placement)
        loc, glo = collect.attributed_bytes(coll, algo, p, PAYLOAD, "lumi",
                                            placement=placement)
        assert glo == want_global, (coll, algo, p, placement)
        assert loc + glo == want_total, (coll, algo, p, placement)
        assert (loc, glo) == jcollect.attributed_bytes(
            coll, algo, p, PAYLOAD, "lumi", placement=placement)
    ttopo = get_topology("torus", p)
    loc, glo = collect.attributed_bytes(coll, algo, p, PAYLOAD, "torus")
    assert glo == 0
    assert loc == traffic.hop_bytes(sched, p, float(PAYLOAD), ttopo)


@pytest.mark.parametrize("p", [8, 16])
def test_trace_replay_matches_reference(p):
    """``tuner.trace``: per-link counters, replayed reductions and the
    hierarchical cut equal the reference's."""
    from repro.topology.presets import get_topology as jget
    topo, jtopo = get_topology("lumi", p), jget("lumi", p)
    place = trace.spread_placement(p, topo, per_group=2)
    assert place == jtrace.spread_placement(p, jtopo, per_group=2)
    for coll in ("allreduce", "reduce_scatter", "allgather"):
        got = trace.trace_collective(coll, "bine", p, float(PAYLOAD), topo,
                                     placement=place)
        exp = jtrace.trace_collective(coll, "bine", p, float(PAYLOAD), jtopo,
                                      placement=place)
        assert (got.link_bytes, got.global_link_bytes, got.steps) == \
            (exp.link_bytes, exp.global_link_bytes, exp.steps)
        assert trace.replayed_reduction(coll, "bine", "recdoub", p,
                                        float(PAYLOAD), topo, place) == \
            jtrace.replayed_reduction(coll, "bine", "recdoub", p,
                                      float(PAYLOAD), jtopo, place)
        assert trace.hier_global_cut(coll, p, float(PAYLOAD), topo) == \
            jtrace.hier_global_cut(coll, p, float(PAYLOAD), jtopo)


def test_records_match_reference(fresh):
    """``record`` (wire scaling, unpriceable backends warned once),
    ``record_serve_plan`` and ``global_local_summary`` leave equal
    registries in both packages."""
    for mod in (collect, jcollect):
        mod._WARNED_KEYS.clear()
        for wire in ("float32", "bfloat16", "int8"):
            mod.record("reduce_scatter", "bine", 8, PAYLOAD,
                       wire_dtype=wire, topology="lumi")
        mod.record("allreduce", "bine", 8, PAYLOAD, topology="lumi",
                   small_cutoff_bytes=0)
        with pytest.warns(UserWarning, match="no link-byte attribution"):
            mod.record("allreduce", "no_such_backend", 8, PAYLOAD,
                       topology="lumi")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            mod.record("allreduce", "no_such_backend", 8, PAYLOAD,
                       topology="lumi")
        mod.record_serve_plan([("allreduce", "bine", 8, 4096),
                               ("allgather", "ring", 8, 8192)],
                              topology="lumi")
        mod._WARNED_KEYS.clear()
    reg, jreg = fresh
    assert reg.snapshot() == jreg.snapshot()
    assert collect.global_local_summary(reg) == \
        jcollect.global_local_summary(jreg)
    with metrics.disabled():
        collect.record("allreduce", "bine", 8, PAYLOAD, topology="lumi")
        collect.record_api(None, "allreduce", 8, PAYLOAD)
    assert reg.snapshot() == jreg.snapshot()


def test_repeated_records_match_reference(fresh):
    """A repeated dispatch (the port caches each signature's label key and
    increments) adds to its counters as the reference's uncached ``record``
    does, also inside a ``scope`` frame, which still labels the series."""
    for mod, reg in zip((collect, jcollect), fresh):
        for _ in range(3):
            mod.record("reduce_scatter", "bine", 8, PAYLOAD,
                       wire_dtype="int8", topology="lumi")
        with reg.scope(replica="1"):
            mod.record("reduce_scatter", "bine", 8, PAYLOAD,
                       wire_dtype="int8", topology="lumi")
            mod.record("allgather", "ring", 4, 4096, topology="torus")
    reg, jreg = fresh
    assert reg.snapshot() == jreg.snapshot()
    labels = dict(collective="reduce_scatter", backend="bine",
                  algo="bine", wire_dtype="int8", topology="lumi", p=8,
                  source="api")
    assert reg.counter_value("collective_calls", **labels) == 3.0
    assert reg.counter_value("collective_calls", replica="1",
                             **labels) == 1.0


@pytest.mark.parametrize("wire", ["float32", "int8", "auto"])
def test_bucket_plan_records_match_reference(wire, fresh):
    """The reduced phi4-mini's step records one reduce-scatter and one
    allgather a bucket at build time, equal to the reference's
    ``record_bucket_plan`` of its own plan; the summary's bytes are the
    closed forms of the buckets' schedules."""
    import jax
    from repro.configs import base as jbase
    from repro.models import transformer as JT
    from repro.train import step as jstep
    from repro.train import zero as jzero
    from repro_torch.configs import base
    from repro_torch.models import transformer as TF
    from repro_torch.topology.cost import schedule_algo
    from repro_torch.train import step as tstep
    p = 4
    kw = dict(backend="auto" if wire == "auto" else "pallas_fused",
              wire_dtype=wire, topology="lumi", bucket_bytes=1 << 12)
    cfg = base.reduced(base.get_config("phi4-mini-3.8b"))
    _, info, _ = tstep.make_train_step(cfg, tstep.TrainConfig(**kw), p,
                                       TF.param_shapes(cfg), "cpu")
    jcfg = jbase.reduced(jbase.get_config("phi4-mini-3.8b"))
    jshapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                             jax.random.key(0))
    jt = jstep.TrainConfig(**kw)
    jplan = jstep.resolve_bucket_plan(jt, p, jshapes,
                                      jzero.zero_layout(jcfg, jshapes, p))
    jcollect.record_bucket_plan(jt, jplan, jstep.bucket_decisions(jt, jplan),
                                p)
    reg, jreg = fresh
    assert reg.snapshot() == jreg.snapshot()
    assert len(info["bucket_plan"].buckets) > 1
    calls = {lab["source"] for lab, _ in reg.series("collective_calls")}
    assert calls == {"train_bucket"}
    # the closed forms: each bucket's schedule at its payload and wire
    want = {}
    topo = get_topology("lumi", p)
    plan, dec = info["bucket_plan"], info["decisions"]
    import torch
    from repro_torch.collectives.compression import wire_factor
    for b, (rs_b, rs_w, ag_b, ag_w) in zip(plan.buckets, dec):
        for coll, be, w, nbytes in (
                ("reduce_scatter", rs_b, rs_w,
                 b.nbytes(plan.wire_itemsize, p)),
                ("allgather", ag_b, ag_w,
                 b.nbytes(getattr(torch, b.dtype).itemsize, p))):
            sc, algo = schedule_algo(coll, be, nbytes)
            sched = get_schedule(sc, algo, p)
            scale = 1.0 if w == "float32" else wire_factor(w)
            g = traffic.global_bytes(sched, p, float(nbytes), topo) * scale
            t = traffic.total_bytes(sched, p, float(nbytes)) * scale
            row = want.setdefault((be, "lumi"), {"global": 0.0, "local": 0.0})
            row["global"] += g
            row["local"] += t - g
    got = collect.global_local_summary(reg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k]["global"] == pytest.approx(want[k]["global"],
                                                 rel=1e-12)
        assert got[k]["local"] == pytest.approx(want[k]["local"], rel=1e-12)
