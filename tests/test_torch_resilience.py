"""The port's fault injection and self-healing supervisor
(``repro_torch.resilience``) against the reference's.

Chaos: ``generate_events`` draws from ``np.random.RandomState``, so for
every seed the port's schedule is the reference's event for event;
``parse_event`` / ``spec`` round trips, ``ChaosSchedule`` views,
``rank_loss_schedule`` / ``lost_ranks`` and ``corrupt_file``'s bytes are
equal too, and ``degrade_topology`` gives every preset the reference's
degraded fields and predicted times.  Supervisor: each scenario runs the
same trace and fault schedule through both packages' ``Fleet`` and
``FleetSupervisor`` on each package's ``ReplayFakeFns`` and
``FakeTimer``: crash mid-tick, stragglers, ``respawn_delay``, ``shed`` and
``requeue`` backpressure.  The report (fleet stats, crash log, MTTR, shed
and requeued requests, heartbeat rows, final health), every heartbeat,
every routing decision and every token stream (also the fake engine's
closed form, ``expected_stream``) must be equal: host logic, so every
bound is exact.  Last, the store-quarantine cases of
``tests/resilience/test_store_quarantine.py`` that touch
``fleet.feedback``, on the port.
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest

from repro import fleet as JF
from repro import resilience as JR
from repro.configs import base as jbase
from repro.fleet import feedback as JFB
from repro.resilience import chaos as JC
from repro.resilience import fakes as JK
from repro.serve import scheduler as JS
from repro.topology import cost as jcost
from repro.topology import presets as jpresets
from repro_torch import fleet as TF
from repro_torch import resilience as TR
from repro_torch.configs import base as tbase
from repro_torch.fleet import feedback as TFB
from repro_torch.resilience import chaos as TC
from repro_torch.resilience import fakes as TK
from repro_torch.serve import scheduler as TS
from repro_torch.topology import cost as tcost
from repro_torch.topology import presets as tpresets
from torch_threads import pin_threads  # noqa: F401

V = TK.V
PKGS = {"jax": (JF, JR, JK, JS, jbase), "torch": (TF, TR, TK, TS, tbase)}


def _outcome(fn):
    """``("ok", value)`` or ``(exception type name, message)``."""
    try:
        return "ok", fn()
    except Exception as e:      # the outcome under test
        return type(e).__name__, str(e)


def _specs(events):
    return [e.spec() for e in events]


# ---------------------------------------------------------------------------
# Chaos
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_generate_events_match_jax(seed):
    """The same seed and arguments give the reference's schedule, and
    every event's spec parses back to it in both packages."""
    for n_ticks, n_rep, n_ev, kinds in (
            (20, 3, 6, TC.FLEET_KINDS), (4, 1, 2, TC.FLEET_KINDS),
            (1, 5, 9, ("crash",)), (50, 2, 12, TC.CHAOS_KINDS)):
        got = TC.generate_events(seed, n_ticks, n_rep, n_ev, kinds=kinds)
        exp = JC.generate_events(seed, n_ticks, n_rep, n_ev, kinds=kinds)
        assert _specs(got) == _specs(exp)
        for ev in got:
            assert TC.parse_event(ev.spec()) == ev
            assert JC.parse_event(ev.spec()).spec() == ev.spec()
        assert TC.ChaosSchedule(got).signature() == \
            JC.ChaosSchedule(exp).signature()
    assert _outcome(lambda: TC.generate_events(seed, 10, 2, kinds=(
        "crash", "meteor"))) == _outcome(lambda: JC.generate_events(
            seed, 10, 2, kinds=("crash", "meteor")))


def test_parse_validate_and_schedule_views_match_jax():
    for spec in ("3:crash:1", "5:straggler:0:4", "7:link_slow:0:2.5",
                 "10:rank_loss:3:2", "0:corrupt_store:0", "4:crash",
                 "1:meteor:0", "-1:crash:0", "2:straggler:0:0"):
        got = _outcome(lambda: TC.parse_event(spec).spec())
        assert got == _outcome(lambda: JC.parse_event(spec).spec()), spec
    evs = ("5:straggler:1:4", "2:crash:0", "5:crash:2", "10:rank_loss:3:2")
    t = TC.ChaosSchedule([TC.parse_event(s) for s in evs])
    j = JC.ChaosSchedule([JC.parse_event(s) for s in evs])
    assert t.signature() == j.signature() == \
        "2:crash:0:1 5:crash:2:1 5:straggler:1:4 10:rank_loss:3:2"
    for tick in range(12):
        assert _specs(t.at(tick)) == _specs(j.at(tick))
    assert _specs(t.of_kind("crash")) == _specs(j.of_kind("crash"))
    assert t.last_tick == j.last_tick == 10
    assert TC.ChaosSchedule().signature() == "(none)"
    assert TC.rank_loss_schedule(t.events) == \
        JC.rank_loss_schedule(j.events) == {10: True}
    for step in (4, 10):
        assert TC.lost_ranks(t.events, step) == JC.lost_ranks(j.events, step)
    assert TC.lost_ranks(t.events, 10) == (3, 4)


def test_corrupt_file_bytes_match_jax(tmp_path):
    for seed, n in ((0, 64), (3, 32), (7, 5)):
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        TC.corrupt_file(a, seed=seed, nbytes=n)
        JC.corrupt_file(b, seed=seed, nbytes=n)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            blob = fa.read()
            assert blob == fb.read() and blob.startswith(b"{corrupt")


@pytest.mark.parametrize("name", jpresets.PRESETS)
def test_degrade_topology_matches_jax(name):
    """Every preset at p = 8 and 64: the degraded topology's fields (the
    global tier only on grouped presets, every link on the torus) and its
    predicted times equal the reference's; a speed-up raises alike."""
    for p in (8, 64):
        tt, tj = tpresets.get_topology(name, p), jpresets.get_topology(name, p)
        for beta, alpha in ((1.0, 1.0), (2.5, 1.0), (4.0, 3.0)):
            dt = TC.degraded_topology(tt, beta, alpha_scale=alpha)
            dj = JC.degraded_topology(tj, beta, alpha_scale=alpha)
            assert (type(dt).__name__, dataclasses.asdict(dt)) == \
                (type(dj).__name__, dataclasses.asdict(dj))
            assert tcost.degrade_topology(tt, beta, alpha) == dt
            for coll, backend in (("allreduce", "bine"),
                                  ("reduce_scatter", "ring"),
                                  ("allgather", "recdoub")):
                assert tcost.predict_time(coll, backend, p, 1 << 24, dt) == \
                    jcost.predict_time(coll, backend, p, 1 << 24, dj)
            if beta > 1.0 and hasattr(dt, "beta_local"):
                assert dt.beta_local == tt.beta_local
        for beta, alpha in ((0.5, 1.0), (2.0, 0.1)):
            assert _outcome(lambda: TC.degraded_topology(tt, beta, alpha)) \
                == _outcome(lambda: JC.degraded_topology(tj, beta, alpha))


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------

def _cfg(pkg):
    base = PKGS[pkg][4]
    return base.reduced(base.get_config("gemma3-4b"))


def _fleet(pkg, n_replicas, n_slots, timer_step=1e-3):
    F, _, K, _, _ = PKGS[pkg]
    fcfg = F.FleetConfig(n_replicas=n_replicas, n_slots=n_slots)
    return F.Fleet(_cfg(pkg), K.ReplayFakeFns(n_slots), None, fcfg,
                   max_seq_len=64, timer=K.FakeTimer(timer_step))


def _zeros(pkg, n):
    Req = PKGS[pkg][3].Request
    return [Req(rid=i, prompt=np.zeros(3, np.int32), max_new_tokens=4,
                arrival=0.0) for i in range(n)]


def _poisson(pkg, seed=3):
    return PKGS[pkg][3].poisson_trace(
        12, rate=1.1, prompt_lens=(2, 8), max_new_tokens=5, vocab_size=V,
        seed=seed, n_sessions=4)


#: scenario -> (replicas, pages, trace, chaos specs, SupervisorConfig kw)
SCENARIOS = {
    # a crash that displaces in-flight work and a straggler tick
    "crash_straggler": (3, 3, _poisson, ("2:crash:0", "4:straggler:1:6"),
                        dict(respawn_delay=2)),
    # a seed-generated schedule of crashes and stragglers
    "generated": (3, 2, lambda pkg: _poisson(pkg, seed=8), "seed:11",
                  dict(respawn_delay=1)),
    # two replicas, each crashed once, a deadline that requeues
    "two_crashes": (2, 2, lambda pkg: _poisson(pkg, seed=9),
                    ("1:crash:1", "3:straggler:0:3", "6:crash:0"),
                    dict(respawn_delay=3, deadline_ticks=3, seed=2)),
    # the only replica dead past the deadline: waiting requests shed
    "shed": (1, 2, lambda pkg: _zeros(pkg, 3), ("0:crash:0",),
             dict(respawn_delay=8, deadline_ticks=2, backpressure="shed")),
    # the same with requeue: delayed with seeded backoff, never dropped
    "requeue": (1, 2, lambda pkg: _zeros(pkg, 3), ("0:crash:0",),
                dict(respawn_delay=4, deadline_ticks=1,
                     backpressure="requeue", seed=5)),
}


def _chaos(pkg, specs, n_replicas):
    C = JC if pkg == "jax" else TC
    if isinstance(specs, str):            # "seed:<s>": a generated schedule
        evs = C.generate_events(int(specs.split(":")[1]), n_ticks=12,
                                n_replicas=n_replicas, n_events=4)
    else:
        evs = [C.parse_event(s) for s in specs]
    return C.ChaosSchedule(evs)


def _supervised(pkg, scenario):
    n_rep, n_slots, make_trace, specs, skw = SCENARIOS[scenario]
    _, R, _, _, _ = PKGS[pkg]
    fleet = _fleet(pkg, n_rep, n_slots)
    routes = []
    route = fleet.router.route

    def recorded(req, healthy, loads):
        d = route(req, healthy, loads)
        routes.append((req.rid, d.replica, d.preferred, d.key, d.spilled))
        return d
    fleet.router.route = recorded
    trace = make_trace(pkg)
    lens = {r.rid: len(r.prompt) for r in trace}
    fleet.submit_trace(trace)
    sup = R.FleetSupervisor(fleet, _chaos(pkg, specs, n_rep),
                            R.SupervisorConfig(**skw))
    report = sup.run()
    assert all(r.finished for r in trace)
    return {"report": report, "routes": routes, "mttr": sup.mttr(),
            "heartbeats": [dataclasses.astuple(h) for h in sup.heartbeats],
            "crash_log": [(c.replica, c.crash_tick, c.displaced,
                           c.respawn_tick, c.ttr) for c in sup.crash_log],
            "streams": {r.rid: [int(t) for t in r.generated] for r in trace},
            "reasons": {r.rid: r.finish_reason for r in trace},
            "lens": lens}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_supervisor_matches_jax(scenario):
    got = _supervised("torch", scenario)
    exp = _supervised("jax", scenario)
    for k in ("report", "routes", "mttr", "heartbeats", "crash_log",
              "streams", "reasons"):
        assert got[k] == exp[k], k
    res = got["report"]["resilience"]
    assert len(res["crashes"]) >= 1
    if scenario == "crash_straggler":
        assert got["crash_log"][0][:2] == (0, 2)
        assert got["crash_log"][0][2] >= 1      # displaced in-flight work
        assert got["mttr"] == 2.0 and got["crash_log"][0][4] == 2
    if scenario == "shed":
        assert res["shed"] == [0, 1, 2]
        assert set(got["reasons"].values()) == {"shed"}
        assert all(not s for s in got["streams"].values())
        return
    if scenario == "requeue":
        assert res["requeued"] > 0 and res["shed"] == []
    for rid, toks in got["streams"].items():
        assert toks == TK.expected_stream(got["lens"][rid], len(toks))


def test_chaos_streams_equal_undisturbed_fleet():
    """A crash mid-tick and a straggler change no token stream against
    the same fleet undisturbed, greedy and at temperature 0.8."""
    for temperature in (0.0, 0.8):
        runs = []
        for chaos in (None, _chaos("torch", ("2:crash:0",
                                             "4:straggler:1:6"), 3)):
            fleet = _fleet("torch", 3, 3)
            trace = TS.poisson_trace(12, rate=1.1, prompt_lens=(2, 8),
                                     max_new_tokens=5, vocab_size=V, seed=3,
                                     temperature=temperature, n_sessions=4)
            fleet.submit_trace(trace)
            if chaos is None:
                fleet.run()
            else:
                sup = TR.FleetSupervisor(fleet, chaos)
                sup.run()
                assert len(sup.crash_log) == 1
            runs.append({r.rid: list(r.generated) for r in trace})
        assert runs[0] == runs[1], temperature


def test_straggler_poisons_ewma_then_respawn_resets():
    """A 1000x straggler tick lifts the target's EWMA; a crash and its
    respawn drop the poisoned estimate."""
    from repro_torch.resilience.supervisor import ReplicaCrash
    fl = _fleet("torch", 2, 3)
    trace = _poisson("torch")
    fl.submit_trace(trace)
    sup = TR.FleetSupervisor(
        fl, TR.ChaosSchedule([TR.FaultEvent(2, "straggler", 0, 1000.0)]))
    while sup.step():
        if fl.clock == 4:
            break
    assert fl.router.latency[0].value > 10 * fl.router.latency[1].value
    assert fl.replicas[0].latency_scale == 1.0
    poisoned = fl.router.latency[0].value
    fl.replicas[0].inject_fault(ReplicaCrash("manual"))
    while sup.step():
        pass
    assert all(r.finished for r in trace)
    assert fl.router.latency[0].value < poisoned / 10


def _guard(pkg, how):
    F, R, _, S, _ = PKGS[pkg]
    if how == "config":
        return [_outcome(lambda: R.SupervisorConfig(backpressure="explode")),
                _outcome(lambda: R.SupervisorConfig(respawn_delay=0))]
    fl = _fleet(pkg, 1, 1 if how == "max_ticks" else 2)
    if how == "max_ticks":
        fl.submit_trace(_poisson(pkg)[:8])
        sup = R.FleetSupervisor(fl, cfg=R.SupervisorConfig(max_ticks=2))
        return _outcome(sup.run)
    fl.submit(S.Request(rid=0, prompt=np.zeros(3, np.int32),
                        max_new_tokens=3, arrival=1.0))
    if how == "stall":
        sup = R.FleetSupervisor(fl)
        return _outcome(lambda: sup.run(events=[F.FleetEvent(0, "drain", 0)]))
    # no supervisor: the replica's exception leaves the loop
    fl.replicas[0].inject_fault(R.ReplicaCrash("nobody is listening"))
    return _outcome(fl.run)


@pytest.mark.parametrize("how", ["max_ticks", "stall", "config", "unhandled"])
def test_supervisor_guards_match_jax(how):
    got = _guard("torch", how)
    assert got == _guard("jax", how)
    want = {"max_ticks": "max_ticks=2", "stall": "stalled",
            "unhandled": "nobody is listening"}
    if how == "config":
        assert [g[0] for g in got] == ["ValueError", "ValueError"]
    else:
        assert want[how] in got[1]
        assert got[0] == ("ReplicaCrash" if how == "unhandled"
                          else "RuntimeError")


# ---------------------------------------------------------------------------
# The feedback store under corruption (tests/resilience/test_store_quarantine)
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_warnings():
    """Per-path warning dedup is process-global; isolate each test."""
    before = set(TFB._WARNED_PATHS), set(JFB._WARNED_PATHS)
    yield
    for store, old in zip((TFB._WARNED_PATHS, JFB._WARNED_PATHS), before):
        store.clear()
        store.update(old)


def _fb(mod):
    return mod.FleetFeedback(
        device_kind="cpu", topology="lumi", p=2,
        provenance={"timestamp": None},
        replicas={"0": mod.ReplicaStats(ticks=3, ewma_tick_s=1e-3)})


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_feedback_store_quarantines_corrupt_file(tmp_path, fresh_warnings,
                                                 writer):
    """A file either package saved, torn by the chaos ``corrupt_file``
    applier: the port's load returns None, quarantines it with one
    warning, and stays quiet on the next hit at the same path."""
    mod, C = (TFB, TC) if writer == "torch" else (JFB, JC)
    path = mod.save_feedback(_fb(mod), dir=str(tmp_path))
    C.corrupt_file(path, seed=7)
    with pytest.warns(UserWarning, match="quarantined") as rec:
        assert TFB.load_feedback("cpu", "lumi", 2, dir=str(tmp_path)) is None
    assert len(rec) == 1
    assert os.path.exists(path + TFB.CORRUPT_SUFFIX)
    assert not os.path.exists(path)
    C.corrupt_file(path, seed=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert TFB.load_feedback("cpu", "lumi", 2, dir=str(tmp_path)) is None


def test_feedback_atomic_write_and_unwritable_dir(tmp_path, fresh_warnings):
    path = TFB.save_feedback(_fb(TFB), dir=str(tmp_path))
    again = TFB.load_feedback("cpu", "lumi", 2, dir=str(tmp_path))
    assert again is not None and again.replicas["0"].ticks == 3
    assert not path.endswith(".tmp")
    assert list(tmp_path.iterdir()) == [tmp_path / "cpu__lumi__p2.json"]
    blocked = tmp_path / "file"
    blocked.write_text("")
    with pytest.warns(UserWarning, match="NOT persisted"):
        assert TFB.save_feedback(_fb(TFB), dir=str(blocked / "sub")) is None
