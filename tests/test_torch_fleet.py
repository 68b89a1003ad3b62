"""The port's serve fleet (``repro_torch.fleet``) against the reference's
(``repro.fleet``) on each package's replay-consistent fake engine.

The same trace (``poisson_trace`` draws its prompts, arrivals and
sessions from numpy, so both packages get the same requests) goes through
both packages' ``Fleet`` with each package's ``ReplayFakeFns`` and
``FakeTimer``: every routing decision, the fleet's ``stats()`` (ticks,
held arrival ticks, routing counters, per-replica state, tokens, steps,
respawns and EWMA tick latency, the latency summary), every token stream
and the feedback file the run saves must be equal, the file byte for
byte.  The fleet is host logic over the engine, so every bound here is
exact.  Also: the placement plans (``plan_placement`` / ``format_plan``)
on every preset at four fleet shapes, scores equal to the bit and the
text identical (both packages hold copies of the same cost model), the
torus's refusal of a non-power-of-two allocation; feedback files written
by one package load in the other; a corrupt file is quarantined once
with one warning; the ``max_ticks`` and stall guards raise the
reference's errors.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

from repro import fleet as JF
from repro.configs import base as jbase
from repro.fleet import feedback as JFB
from repro.fleet import placement as JP
from repro.resilience import fakes as JK
from repro.serve import scheduler as JS
from repro_torch import fleet as TF
from repro_torch.configs import base as tbase
from repro_torch.fleet import feedback as TFB
from repro_torch.fleet import placement as TP
from repro_torch.resilience import fakes as TK
from repro_torch.serve import scheduler as TS
from repro_torch.topology.presets import PRESETS
from torch_threads import pin_threads  # noqa: F401

V = TK.V
PKGS = {"jax": (JF, JK, JS, jbase), "torch": (TF, TK, TS, tbase)}

#: scenario -> (replicas, pages, trace kwargs, events, FleetConfig kwargs)
SCENARIOS = {
    # drains and a respawn mid-trace over session-affine traffic
    "drain_respawn": (3, 3, dict(n=12, rate=1.1, seed=3),
                      ((3, "drain", 0), (8, "respawn", 0), (6, "drain", 2)),
                      {}),
    # one page a replica and no slack: affinity yields to load
    "spill": (2, 1, dict(n=10, rate=3.0, seed=4), (), dict(spill_slack=0)),
    # the whole fleet draining holds arrivals until a respawn
    "held": (2, 2, dict(n=6, rate=0.7, seed=5),
             ((0, "drain", 0), (0, "drain", 1), (4, "respawn", 0)), {}),
    # four replicas, two drained for good, a spill slack of one request
    "shrink": (4, 2, dict(n=14, rate=1.5, seed=6),
               ((2, "drain", 3), (5, "drain", 1)), dict(spill_slack=1)),
}


def _outcome(fn):
    """``("ok", value)`` or ``(exception type name, message)``."""
    try:
        return "ok", fn()
    except Exception as e:      # the outcome under test
        return type(e).__name__, str(e)


def _cfg(pkg):
    return PKGS[pkg][3].reduced(PKGS[pkg][3].get_config("gemma3-4b"))


def _trace(pkg, n, rate, seed, temperature=0.0):
    return PKGS[pkg][2].poisson_trace(
        n, rate=rate, prompt_lens=(2, 8), max_new_tokens=5, vocab_size=V,
        seed=seed, temperature=temperature, n_sessions=4)


def _fleet(pkg, n_replicas, n_slots, timer_step=1e-3, **kw):
    F, K, _, _ = PKGS[pkg]
    fcfg = F.FleetConfig(n_replicas=n_replicas, n_slots=n_slots, **kw)
    return F.Fleet(_cfg(pkg), K.ReplayFakeFns(n_slots), None, fcfg,
                   max_seq_len=64, timer=K.FakeTimer(timer_step))


def _record_routes(fleet):
    """Every routing decision of ``fleet`` as (rid, replica, preferred,
    key, spilled)."""
    log = []
    route = fleet.router.route

    def recorded(req, healthy, loads):
        d = route(req, healthy, loads)
        log.append((req.rid, d.replica, d.preferred, d.key, d.spilled))
        return d
    fleet.router.route = recorded
    return log


def _run(pkg, scenario, tmp_path=None, temperature=0.0, **extra):
    n_rep, n_slots, tkw, evs, fkw = SCENARIOS[scenario]
    F = PKGS[pkg][0]
    if tmp_path is not None:
        fkw = dict(fkw, device_kind="cpu", topology="lumi",
                   feedback_dir=str(tmp_path / pkg))
    fleet = _fleet(pkg, n_rep, n_slots, **dict(fkw, **extra))
    routes = _record_routes(fleet)
    trace = _trace(pkg, temperature=temperature, **tkw)
    fleet.submit_trace(trace)
    stats = fleet.run(events=[F.FleetEvent(*e) for e in evs])
    assert all(r.finished for r in trace)
    out = {"routes": routes, "stats": stats, "fleet": fleet,
           "streams": {r.rid: [int(t) for t in r.generated] for r in trace},
           "prompt_lens": {r.rid: len(r.prompt) for r in trace}}
    if tmp_path is not None:
        path = fleet.save_feedback(timestamp="2026-10-18T00:00:00Z")
        with open(path, "rb") as f:
            out["feedback"] = (os.path.basename(path), f.read())
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_fleet_matches_jax(scenario, tmp_path):
    """Routing decisions, stats, streams and the saved feedback file, all
    exactly the reference's; greedy streams also the fake engine's closed
    form."""
    exp = _run("jax", scenario, tmp_path)
    got = _run("torch", scenario, tmp_path)
    assert got["routes"] == exp["routes"]
    assert got["stats"] == exp["stats"]
    assert got["streams"] == exp["streams"]
    assert got["feedback"] == exp["feedback"]
    for rid, toks in got["streams"].items():
        assert toks == TK.expected_stream(got["prompt_lens"][rid], 5)
    if scenario == "held":
        assert got["stats"]["held_arrival_ticks"] > 0
    if scenario == "spill":
        assert got["stats"]["routing"]["n_spilled"] > 0


def test_fleet_equals_single_replica_sampled():
    """Temperature 0.8: the fleet with drains and a respawn gives every
    request the stream one replica gives it (sampling streams are keyed
    by request and token index)."""
    fleet = _run("torch", "drain_respawn", temperature=0.8)
    n_slots = SCENARIOS["drain_respawn"][1] * SCENARIOS["drain_respawn"][0]
    one = _fleet("torch", 1, n_slots)
    trace = _trace("torch", 12, 1.1, 3, temperature=0.8)
    one.submit_trace(trace)
    one.run()
    assert {r.rid: [int(t) for t in r.generated] for r in trace} == \
        fleet["streams"]


def test_warm_start_from_the_other_package(tmp_path):
    """A feedback file one package saved warm-starts the other's router,
    and the warm-started runs decide alike."""
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        d = tmp_path / writer
        _run(writer, "drain_respawn", tmp_path, timer_step=2e-3)
        n_rep, n_slots, tkw, evs, fkw = SCENARIOS["spill"]
        runs = {}
        for pkg in (reader, writer):
            fleet = _fleet(pkg, 3, 1, device_kind="cpu", topology="lumi",
                           feedback_dir=str(d), spill_slack=0)
            assert [fleet.router.latency[r].count for r in range(3)] == \
                [1, 1, 1]
            assert fleet.router.latency[0].value == pytest.approx(2e-3)
            routes = _record_routes(fleet)
            trace = _trace(pkg, **tkw)
            fleet.submit_trace(trace)
            runs[pkg] = (routes, fleet.run())
        assert runs[reader] == runs[writer]


SHAPES = ((8, 2, 4), (16, 4, 4), (12, 3, 4), (8, 8, 1))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("preset", PRESETS)
def test_placement_matches_jax(preset, shape):
    """``plan_placement`` at ``(ranks, replicas, tp)`` on full gemma3-4b's
    decode payloads (4 pages): every field equal, every score to the
    bit, ``format_plan``'s text identical; or the same error."""
    tcfg = tbase.get_config("gemma3-4b")
    jcfg = jbase.get_config("gemma3-4b")
    tpay = TP.decode_payloads(4, tcfg.n_heads, tcfg.head_dim, tcfg.vocab_size)
    jpay = JP.decode_payloads(4, jcfg.n_heads, jcfg.head_dim, jcfg.vocab_size)
    assert tpay == jpay
    got = _outcome(lambda: TP.plan_placement(preset, *shape, tpay))
    exp = _outcome(lambda: JP.plan_placement(preset, *shape, jpay))
    if preset == "torus" and shape[0] == 12:
        assert exp[0] == "ValueError"
        assert "torus preset needs a power-of-two p" in exp[1]
    assert got[0] == exp[0]
    if got[0] != "ok":
        assert got == exp
        return
    g, e = got[1], exp[1]
    for f in ("preset", "n_ranks", "n_replicas", "tp", "per_group", "tiers",
              "dims", "allocation", "placements", "chosen"):
        assert getattr(g, f) == getattr(e, f), f
    assert {k: dataclasses.astuple(v) for k, v in g.scores.items()} == \
        {k: dataclasses.astuple(v) for k, v in e.scores.items()}
    assert TP.format_plan(g) == JP.format_plan(e)


@pytest.fixture
def fresh_warnings():
    """Per-path warning dedup is process-global; isolate each test."""
    before = set(TFB._WARNED_PATHS), set(JFB._WARNED_PATHS)
    yield
    for store, old in zip((TFB._WARNED_PATHS, JFB._WARNED_PATHS), before):
        store.clear()
        store.update(old)


def _feedback(mod):
    return mod.FleetFeedback(
        device_kind="NVIDIA H100 80GB HBM3", topology="lumi", p=3,
        provenance={"timestamp": "t0", "source": "repro.fleet"},
        replicas={"0": mod.ReplicaStats(ticks=4, ewma_tick_s=1.5e-3,
                                        p50_tick_s=1e-3, p99_tick_s=4e-3),
                  "2": mod.ReplicaStats(ticks=0)},
        latency={"requests": {"n": 3.0, "ttft_p50": 1.0}})


def test_feedback_files_cross_both_ways(tmp_path, fresh_warnings):
    """Each package's file, at the reference's path and name, loads in
    the other with every field; the two write the same bytes."""
    paths = {}
    for name, mod in (("jax", JFB), ("torch", TFB)):
        paths[name] = mod.save_feedback(_feedback(mod),
                                        dir=str(tmp_path / name))
        assert os.path.basename(paths[name]) == \
            "NVIDIA-H100-80GB-HBM3__lumi__p3.json"
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    for writer, mod in (("torch", JFB), ("jax", TFB)):
        fb = mod.load_feedback("NVIDIA H100 80GB HBM3", "lumi", 3,
                               dir=str(tmp_path / writer))
        assert fb.to_json_dict() == _feedback(mod).to_json_dict()
        assert fb.warm_start() == {0: 1.5e-3}


def test_feedback_dir_env_and_format_checks(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FLEET_FEEDBACK_DIR", str(tmp_path))
    assert TFB.feedback_dir() == JFB.feedback_dir() == str(tmp_path)
    monkeypatch.delenv("REPRO_FLEET_FEEDBACK_DIR")
    assert TFB.feedback_dir() == JFB.feedback_dir()
    for blob in ('{"format": 99}', '{"format": 1}', "[1, 2]"):
        assert _outcome(lambda: TFB.FleetFeedback.from_json_dict(
            json.loads(blob)))[0] == _outcome(
            lambda: JFB.FleetFeedback.from_json_dict(json.loads(blob)))[0]


def test_corrupt_feedback_quarantined_once(tmp_path, fresh_warnings):
    """An unparseable file: ``None``, renamed ``.corrupt`` with one warning;
    a second corrupt file at the same path warns no more."""
    path = TFB.save_feedback(_feedback(TFB), dir=str(tmp_path))
    with open(path, "w") as f:
        f.write("{not json")
    with pytest.warns(UserWarning, match="quarantined") as rec:
        assert TFB.load_feedback("NVIDIA H100 80GB HBM3", "lumi", 3,
                                 dir=str(tmp_path)) is None
    assert len(rec) == 1
    assert not os.path.exists(path)
    assert os.path.exists(path + TFB.CORRUPT_SUFFIX)
    with open(path, "w") as f:
        f.write('{"format": 99}')
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert TFB.load_feedback("NVIDIA H100 80GB HBM3", "lumi", 3,
                                 dir=str(tmp_path)) is None


def _guard_outcome(pkg, how):
    F = PKGS[pkg][0]
    fleet = _fleet(pkg, 1, 1 if how == "max_ticks" else 2)
    Req = PKGS[pkg][2].Request
    if how == "max_ticks":
        fleet.submit_trace(_trace(pkg, 8, 1.1, 3))
        return _outcome(lambda: fleet.run(max_ticks=2))
    fleet.submit(Req(rid=0, prompt=np.zeros(3, np.int32), max_new_tokens=3,
                     arrival=1.0))
    return _outcome(lambda: fleet.run(events=[F.FleetEvent(0, "drain", 0)]))


@pytest.mark.parametrize("how", ["max_ticks", "stall"])
def test_fleet_guards_raise_like_jax(how):
    """A tick budget exceeded, and a schedule that leaves no ACTIVE
    replica and no respawn: the reference's ``RuntimeError`` and
    message."""
    got = _guard_outcome("torch", how)
    assert got[0] == "RuntimeError"
    assert got == _guard_outcome("jax", how)
    assert ("max_ticks=2" if how == "max_ticks" else "failed to drain") \
        in got[1]


def test_replica_lifecycle_and_events():
    """Respawn before a drain raises; an idle drain stops at once; history
    survives a respawn; an unknown event action raises the reference's
    ``ValueError``."""
    from repro_torch.fleet.replica import ACTIVE, STOPPED
    fleet = _fleet("torch", 1, 2)
    rep = fleet.replicas[0]
    with pytest.raises(ValueError, match="drain to STOPPED"):
        rep.respawn()
    fleet.submit(TS.Request(rid=0, prompt=np.zeros(4, np.int32),
                            max_new_tokens=3))
    fleet.run()
    assert rep.tokens_out == 3
    rep.drain()
    assert rep.state == STOPPED
    rep.respawn()
    assert rep.state == ACTIVE and rep.n_respawns == 1
    assert rep.tokens_out == 3 and len(rep.request_latencies()) == 1
    assert _outcome(lambda: TF.FleetEvent(0, "reboot", 0)) == \
        _outcome(lambda: JF.FleetEvent(0, "reboot", 0))
    assert _outcome(lambda: _fleet("torch", 0, 1)) == \
        _outcome(lambda: _fleet("jax", 0, 1))
    with pytest.raises(ValueError, match="device_kind"):
        fleet.save_feedback()
