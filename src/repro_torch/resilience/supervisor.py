"""Self-healing fleet supervision: heartbeats, crash -> respawn, backpressure.

Port of ``repro.resilience.supervisor``: the same crash log, MTTR and
backoff draws (a seeded ``np.random.RandomState``) as the reference's on
the same trace and schedule.

The :class:`FleetSupervisor` owns a :class:`repro_torch.fleet.fleet.Fleet`'s
run loop and layers three behaviors over it, none of which change any
request's token stream (the fleet-equivalence property extends through
crashes — tests/test_torch_fleet_engine.py):

  * **Chaos arming** — scheduled
    :class:`~repro_torch.resilience.chaos.FaultEvent` faults are applied at their tick: ``crash`` arms
    :meth:`Replica.inject_fault` (the exception surfaces through the real
    tick path, mid-tick), ``straggler`` scales the next measured tick
    latency (poisons the router EWMA the way a slow host would).
  * **Crash recovery** — an unplanned replica exception (injected or
    genuine) is caught by the fleet's ``fault_handler`` hook, converted
    into :meth:`Replica.crash` (waiting + in-flight requests ejected,
    in-flight ones with their generated prefix folded into the prompt so
    replay re-derives their continuations: the same tokens in float32,
    while on the card a bf16 prefill of the folded prefix may round
    otherwise than the decode steps it replaces), the displaced requests
    resubmitted through the router, and a respawn scheduled
    ``respawn_delay`` ticks out.  Time-to-recovery per crash is recorded
    (the MTTR).
  * **Admission backpressure** — un-routed requests that have waited
    longer than ``deadline_ticks`` are shed (finished with reason
    ``"shed"``) or re-queued with a deterministic seed-jittered backoff,
    so an overloaded or crash-thinned fleet degrades by policy instead of
    by unbounded queue growth.

Everything is driven by the fleet's integer virtual clock and seeded
RNGs: same trace + same chaos schedule -> the identical run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.fleet.fleet import Fleet, FleetEvent
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import timeline as obs_timeline
from repro_torch.resilience.chaos import ChaosSchedule


class ReplicaCrash(RuntimeError):
    """The injected unplanned-replica-failure exception.  Genuine engine
    exceptions take the same recovery path; this type exists so chaos
    runs are distinguishable from real faults in logs."""


@dataclass(frozen=True)
class SupervisorConfig:
    #: ticks from crash to respawn (the fleet readmits the replica then)
    respawn_delay: int = 1
    #: un-routed requests older than this many ticks hit backpressure;
    #: None disables the deadline entirely
    deadline_ticks: Optional[int] = None
    #: what backpressure does: "requeue" (deterministic jittered backoff)
    #: or "shed" (finish the request unserved with reason "shed")
    backpressure: str = "requeue"
    #: requeue backoff: new arrival = now + base + U{0..jitter} (seeded)
    backoff_base: int = 1
    backoff_jitter: int = 2
    #: seed for the backoff jitter draw (per-supervisor RandomState)
    seed: int = 0
    #: hard tick budget for :meth:`FleetSupervisor.run`; None = no guard
    max_ticks: Optional[int] = None

    def __post_init__(self):
        if self.backpressure not in ("requeue", "shed"):
            raise ValueError(
                f"backpressure must be 'requeue' or 'shed', got "
                f"{self.backpressure!r}")
        if self.respawn_delay < 1:
            raise ValueError("respawn_delay must be >= 1 (a crashed "
                             "replica cannot respawn within its own tick)")


@dataclass
class CrashRecord:
    """One crash -> recovery cycle (the MTTR ledger entry)."""
    replica: int
    crash_tick: int
    displaced: int
    respawn_tick: Optional[int] = None

    @property
    def ttr(self) -> Optional[int]:
        """Ticks from crash to the replica rejoining the healthy set."""
        if self.respawn_tick is None:
            return None
        return self.respawn_tick - self.crash_tick


@dataclass
class HealthProbe:
    """One per-tick heartbeat row for one replica."""
    tick: int
    replica: int
    state: str
    load: int
    crashes: int


class FleetSupervisor:
    """Drives a fleet to drain under a chaos schedule, healing as it goes.

    The supervisor owns the loop (it cannot ride :meth:`Fleet.run`, whose
    stall heuristic only knows the static event list — respawns here are
    scheduled dynamically in response to crashes).  Per tick it arms due
    faults, fires due respawns, applies deadline backpressure, steps the
    fleet once, and records a heartbeat for every replica.
    """

    def __init__(self, fleet: Fleet, chaos: ChaosSchedule = ChaosSchedule(),
                 cfg: SupervisorConfig = SupervisorConfig()):
        self.fleet = fleet
        self.chaos = chaos
        self.cfg = cfg
        self._rng = np.random.RandomState(cfg.seed)
        #: replica id -> tick at which to respawn it
        self._respawn_at: Dict[int, int] = {}
        self.crash_log: List[CrashRecord] = []
        self.heartbeats: List[HealthProbe] = []
        self.shed_rids: List[int] = []
        self.n_requeued = 0
        fleet.fault_handler = self._on_fault

    # -- crash recovery ------------------------------------------------------

    def _on_fault(self, rep, exc: BaseException) -> None:
        """The fleet's ``fault_handler``: unplanned exception -> crash,
        replay-resubmit the displaced requests, schedule the respawn."""
        now = self.fleet.clock
        displaced = rep.crash()
        self.crash_log.append(CrashRecord(
            replica=rep.rid, crash_tick=now, displaced=len(displaced)))
        if obs_metrics.enabled():
            obs_metrics.get_registry().inc(
                "fleet_crashes", 1.0, replica=rep.rid)
            obs_timeline.get_timeline().instant(
                "replica_crash", "fleet", float(now), track=str(rep.rid),
                replica=rep.rid, displaced=len(displaced))
        for req in displaced:
            # in-flight prefixes were folded into the prompt by eject_all;
            # re-routing is plain resubmission (arrival is in the past, so
            # the request is delivered on the next tick's arrival pass)
            self.fleet.submit(req)
        self._respawn_at[rep.rid] = now + self.cfg.respawn_delay

    def _fire_respawns(self) -> None:
        now = self.fleet.clock
        due = [rid for rid, t in self._respawn_at.items() if t <= now]
        for rid in sorted(due):
            rep = self.fleet.replicas[rid]
            rep.respawn()
            if obs_metrics.enabled():
                obs_metrics.get_registry().inc("fleet_respawns", 1.0,
                                               replica=rid)
                obs_timeline.get_timeline().instant(
                    "replica_respawn", "fleet", float(now), track=str(rid))
            # a fresh incarnation's latency is not the dead one's: drop
            # the EWMA so the router re-learns instead of trusting a
            # possibly straggler-poisoned estimate
            self.fleet.router.reset(rid)
            del self._respawn_at[rid]
            for rec in reversed(self.crash_log):
                if rec.replica == rid and rec.respawn_tick is None:
                    rec.respawn_tick = now
                    break

    # -- chaos arming --------------------------------------------------------

    def _arm_chaos(self) -> None:
        for ev in self.chaos.at(self.fleet.clock):
            if obs_metrics.enabled():
                obs_metrics.get_registry().inc(
                    "chaos_events", 1.0, kind=ev.kind, target=ev.target)
                obs_timeline.get_timeline().instant(
                    f"chaos_{ev.kind}", "chaos", float(ev.tick),
                    track=str(ev.target), kind=ev.kind, target=ev.target,
                    magnitude=ev.magnitude)
            if ev.kind == "crash":
                self.fleet.replicas[ev.target].inject_fault(ReplicaCrash(
                    f"chaos: injected crash of replica {ev.target} at "
                    f"tick {ev.tick}"))
            elif ev.kind == "straggler":
                self.fleet.replicas[ev.target].latency_scale = ev.magnitude
            # link_slow / rank_loss / corrupt_store are not per-tick fleet
            # faults: they are applied by the launcher / train runtime
            # before or outside the serve loop (see resilience.chaos)

    # -- backpressure --------------------------------------------------------

    def _backpressure(self) -> None:
        if self.cfg.deadline_ticks is None:
            return
        now = self.fleet.clock
        keep = []
        for arrival, rid, req in self.fleet._pending:
            if now - arrival <= self.cfg.deadline_ticks:
                keep.append((arrival, rid, req))
            elif self.cfg.backpressure == "shed":
                req.finished = True
                req.finish_reason = "shed"
                req.finished_at = float(now)
                self.shed_rids.append(req.rid)
                if obs_metrics.enabled():
                    obs_metrics.get_registry().inc("fleet_shed")
            else:
                jitter = int(self._rng.randint(self.cfg.backoff_jitter + 1))
                req.arrival = float(now + self.cfg.backoff_base + jitter)
                keep.append((req.arrival, rid, req))
                self.n_requeued += 1
                if obs_metrics.enabled():
                    obs_metrics.get_registry().inc("fleet_requeued")
        keep.sort()
        self.fleet._pending[:] = keep

    # -- the loop ------------------------------------------------------------

    def _heartbeat(self) -> None:
        tick = self.fleet.clock
        for rep in self.fleet.replicas:
            self.heartbeats.append(HealthProbe(
                tick=tick, replica=rep.rid, state=rep.state, load=rep.load,
                crashes=rep.n_crashes))

    def step(self, events: Sequence[FleetEvent] = ()) -> bool:
        """One supervised tick; returns False when fully drained."""
        self._fire_respawns()
        self._arm_chaos()
        self._backpressure()
        self._heartbeat()
        return self.fleet.step(events)

    def _stalled(self) -> bool:
        """Pending work, nothing ACTIVE, and no respawn scheduled —
        the dynamic-recovery analogue of :meth:`Fleet._stalled`."""
        return (bool(self.fleet._pending) and not self.fleet._healthy()
                and not self._respawn_at)

    def run(self, events: Sequence[FleetEvent] = ()) -> dict:
        """Drain the fleet under the chaos schedule; returns
        :meth:`report` (fleet stats + resilience accounting)."""
        events = tuple(events)
        while self.step(events):
            if (self.cfg.max_ticks is not None
                    and self.fleet.clock > self.cfg.max_ticks):
                raise RuntimeError(
                    f"supervised fleet exceeded max_ticks="
                    f"{self.cfg.max_ticks} (pending="
                    f"{len(self.fleet._pending)}, crashes="
                    f"{len(self.crash_log)})")
            if self._stalled():
                raise RuntimeError(
                    f"supervised fleet stalled at tick {self.fleet.clock}: "
                    f"pending requests, no ACTIVE replica, no scheduled "
                    f"respawn")
        # pending-but-unfired respawns after drain still heal the fleet
        while self._respawn_at:
            self.fleet.clock += 1
            self._fire_respawns()
        return self.report()

    # -- accounting ----------------------------------------------------------

    def mttr(self) -> Optional[float]:
        """Mean ticks-to-recovery over recovered crashes (None if no
        crash happened)."""
        ttrs = [rec.ttr for rec in self.crash_log if rec.ttr is not None]
        if not ttrs:
            return None
        return float(np.mean(ttrs))

    def report(self) -> dict:
        stats = self.fleet.stats()
        if obs_metrics.enabled():
            mttr = self.mttr()
            if mttr is not None:
                obs_metrics.get_registry().set_gauge("fleet_mttr_ticks",
                                                     mttr)
        stats["resilience"] = {
            "chaos_signature": self.chaos.signature(),
            "crashes": [
                {"replica": rec.replica, "crash_tick": rec.crash_tick,
                 "displaced": rec.displaced,
                 "respawn_tick": rec.respawn_tick, "ttr": rec.ttr}
                for rec in self.crash_log
            ],
            "mttr_ticks": self.mttr(),
            "shed": sorted(self.shed_rids),
            "requeued": self.n_requeued,
            "heartbeat_rows": len(self.heartbeats),
            "final_health": {
                rep.rid: {"state": rep.state, "crashes": rep.n_crashes,
                          "respawns": rep.n_respawns}
                for rep in self.fleet.replicas
            },
        }
        return stats
