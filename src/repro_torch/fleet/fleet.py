"""The fleet loop: route arrivals, tick replicas, feed latency back.

Port of ``repro.fleet.fleet``, with its obs hooks on the port's
``obs.metrics`` / ``obs.timeline``.

One global virtual clock (integer ticks, the scheduler convention) drives
everything:

  1. **Elasticity events** scheduled for this tick fire first: ``drain``
     ejects a replica's un-admitted queue and re-routes it over the
     remaining ACTIVE replicas; ``respawn`` brings a STOPPED replica back
     with a fresh scheduler + pool.
  2. **Arrivals** due at this tick route via the
     :class:`~repro_torch.fleet.router.AffinityRouter` — session/prefix
     affinity, least-loaded spill weighted by *measured* EWMA tick
     latency.
  3. **Every replica with work ticks once** (one decode step across its
     pool); each tick's wall latency feeds the router's EWMA and the
     per-replica latency log that :meth:`Fleet.feedback` persists through
     :mod:`repro_torch.fleet.feedback`.

Replicas share one ``serve.engine.make_serve_fns`` and one copy of the
weights, so a fleet costs N pool states.  Because every replica's
scheduler is seeded identically and each sampling stream is keyed per
(request, token-index), the fleet produces the same per-request token
streams as a single replica serving the same trace — including across
mid-trace drains and respawns (on the card, at one pool size: cuBLAS may
pick other kernels for another batch size).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet import feedback as FB
from repro_torch.fleet.replica import ACTIVE, Replica
from repro_torch.fleet.router import AffinityRouter
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import timeline as obs_timeline
from repro_torch.serve.scheduler import Request, latency_summary


@dataclass(frozen=True)
class FleetEvent:
    """One elasticity event: ``action`` in {"drain", "respawn"} fires on
    replica ``replica`` at fleet tick ``tick``."""
    tick: int
    action: str
    replica: int

    def __post_init__(self):
        if self.action not in ("drain", "respawn"):
            raise ValueError(f"unknown fleet event action {self.action!r}")


@dataclass(frozen=True)
class FleetConfig:
    n_replicas: int
    #: KV pages per replica
    n_slots: int
    topology: str = "tpu_multipod"
    seed: int = 0
    top_k: int = 0
    top_p: float = 0.0
    ewma_alpha: float = FB.EWMA_ALPHA
    #: affinity yields to load past this many extra requests on the
    #: preferred replica; None = one pool's worth (n_slots)
    spill_slack: Optional[int] = None
    #: feedback-store key part + persistence (None device_kind disables
    #: both warm start and save)
    device_kind: Optional[str] = None
    feedback_dir: Optional[str] = None
    warm_start: bool = True


class Fleet:
    """N data-parallel replicas + router over one set of engine fns."""

    def __init__(self, model_cfg, fns, params, fcfg: FleetConfig,
                 max_seq_len: int, timer=None):
        if fcfg.n_replicas < 1:
            raise ValueError("need at least one replica")
        self.cfg = fcfg
        kw = {} if timer is None else {"timer": timer}
        self.replicas = [
            Replica(i, model_cfg, fns, params, fcfg.n_slots, max_seq_len,
                    top_k=fcfg.top_k, top_p=fcfg.top_p, seed=fcfg.seed,
                    **kw)
            for i in range(fcfg.n_replicas)
        ]
        self.router = AffinityRouter(
            replica_ids=range(fcfg.n_replicas),
            spill_slack=(fcfg.spill_slack if fcfg.spill_slack is not None
                         else fcfg.n_slots),
            ewma_alpha=fcfg.ewma_alpha)
        self._pending: List[Tuple[float, int, Request]] = []
        self._tick_log: Dict[int, List[float]] = {
            r.rid: [] for r in self.replicas}
        self.clock = 0
        self._held = 0      # ticks arrivals waited because nothing was ACTIVE
        #: crash policy: ``None`` re-raises a replica-tick exception (the
        #: pre-supervisor behavior — the loop dies); a supervisor installs
        #: ``handler(replica, exc)`` to convert it into crash -> respawn
        #: (see ``repro_torch.resilience.supervisor.FleetSupervisor``)
        self.fault_handler = None
        if fcfg.device_kind is not None and fcfg.warm_start:
            prior = FB.load_feedback(fcfg.device_kind, fcfg.topology,
                                     fcfg.n_replicas, dir=fcfg.feedback_dir)
            if prior is not None:
                self.router.warm_start(prior.warm_start())

    # -- submission ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request for routing at its arrival tick."""
        self._pending.append((req.arrival, req.rid, req))
        self._pending.sort()

    def submit_trace(self, reqs: Sequence[Request]) -> None:
        for r in reqs:
            self.submit(r)

    # -- the loop ------------------------------------------------------------

    def _healthy(self) -> List[int]:
        return [r.rid for r in self.replicas if r.state == ACTIVE]

    def _loads(self) -> Dict[int, int]:
        return {r.rid: r.load for r in self.replicas}

    def _route_one(self, req: Request) -> None:
        decision = self.router.route(req, self._healthy(), self._loads())
        self.replicas[decision.replica].submit(req)

    def _deliver_arrivals(self) -> None:
        while self._pending and self._pending[0][0] <= self.clock:
            if not self._healthy():
                # whole fleet draining: hold arrivals for a respawn event
                self._held += 1
                return
            self._route_one(self._pending.pop(0)[2])

    def step(self, events: Sequence[FleetEvent] = ()) -> bool:
        """One fleet tick; returns False when fully drained."""
        for ev in events:
            if ev.tick != self.clock:
                continue
            rep = self.replicas[ev.replica]
            if obs_metrics.enabled():
                obs_timeline.get_timeline().instant(
                    f"replica_{ev.action}", "fleet", float(self.clock),
                    track=str(ev.replica), replica=ev.replica)
                obs_metrics.get_registry().inc(
                    f"fleet_{ev.action}s", 1.0, replica=ev.replica)
            if ev.action == "drain":
                for req in rep.drain():
                    if self._healthy():
                        self._route_one(req)
                    else:
                        self.submit(req)
            else:
                rep.respawn()
        self._deliver_arrivals()
        for rep in self.replicas:
            try:
                report = rep.tick(self.clock)
            except Exception as e:
                # an unplanned replica exception: without a supervisor it
                # kills the loop (re-raised, launch/fleet.py reports it);
                # with one it becomes crash -> replay -> respawn
                if self.fault_handler is None:
                    raise
                self.fault_handler(rep, e)
                continue
            if report.worked:
                self._tick_log[rep.rid].append(report.latency_s)
                self.router.observe(rep.rid, report.latency_s)
                if obs_metrics.enabled():
                    obs_metrics.get_registry().observe(
                        "fleet_tick_seconds", report.latency_s,
                        replica=rep.rid)
                    # virtual tick clock: 1 tick = 1 µs in the trace
                    obs_timeline.get_timeline().span(
                        "fleet_tick", "fleet", float(self.clock), 1.0,
                        track=str(rep.rid), replica=rep.rid,
                        latency_s=report.latency_s)
        self.clock += 1
        return bool(self._pending or any(r.has_work for r in self.replicas))

    def run(self, events: Sequence[FleetEvent] = (),
            max_ticks: Optional[int] = None) -> dict:
        """Drain every submitted request; returns :meth:`stats`.

        ``events`` fire at their scheduled tick.  A fleet whose every
        replica is draining holds arrivals until a respawn; a trace that
        can never drain (no ACTIVE replica and no future respawn) raises
        instead of spinning.  ``max_ticks`` is the guard against stall
        scenarios the heuristic cannot see (a livelocked engine, an event
        schedule that starves a request forever): exceeding it raises
        instead of looping silently.
        """
        events = tuple(events)
        while self.step(events):
            if max_ticks is not None and self.clock > max_ticks:
                raise RuntimeError(
                    f"fleet exceeded max_ticks={max_ticks} with "
                    f"{len(self._pending)} pending and "
                    f"{sum(r.has_work for r in self.replicas)} replicas "
                    f"still holding work — livelock or undersized budget")
            if self._stalled(events):
                raise RuntimeError(
                    f"fleet failed to drain at tick {self.clock} "
                    f"(pending={len(self._pending)}, "
                    f"states={[r.state for r in self.replicas]}) — "
                    f"the event schedule leaves no ACTIVE replica and "
                    f"no future respawn")
        return self.stats()

    def _stalled(self, events: Sequence[FleetEvent]) -> bool:
        """True when pending requests can never be served: every replica
        is drained/draining and no respawn is still scheduled.  (All
        other states progress: DRAINING replicas retire their in-flight
        work tick by tick, and bounded ``max_new_tokens`` retires every
        admitted request.)"""
        return bool(self._pending) and not self._healthy() and not any(
            e.action == "respawn" and e.tick >= self.clock for e in events)

    # -- accounting ----------------------------------------------------------

    def request_latencies(self) -> List[Dict[str, float]]:
        out: List[Dict[str, float]] = []
        for rep in self.replicas:
            out.extend(rep.request_latencies())
        return sorted(out, key=lambda r: r["rid"])

    def stats(self) -> dict:
        lat = self.request_latencies()
        per_replica = {
            rep.rid: {
                "state": rep.state,
                "tokens_out": rep.tokens_out,
                "decode_steps": rep.decode_steps,
                "respawns": rep.n_respawns,
                "ewma_tick_s": self.router.latency[rep.rid].value,
            }
            for rep in self.replicas
        }
        return {
            "ticks": self.clock,
            "tokens_out": sum(r.tokens_out for r in self.replicas),
            "decode_steps": sum(r.decode_steps for r in self.replicas),
            "held_arrival_ticks": self._held,
            "latency": latency_summary(lat),
            "routing": self.router.snapshot(),
            "replicas": per_replica,
        }

    # -- measured-latency persistence ---------------------------------------

    def feedback(self, timestamp: Optional[str] = None,
                 provenance: Optional[Dict[str, Optional[str]]] = None
                 ) -> FB.FleetFeedback:
        """The run's measured per-replica latency as a provenance-stamped
        feedback set, keyed (device_kind, topology, n_replicas).  The
        ``source`` label is the reference's, so the two packages write the
        same bytes for the same run."""
        prov: Dict[str, Optional[str]] = {"timestamp": timestamp,
                                          "source": "repro.fleet"}
        if provenance:
            prov.update(provenance)
        fb = FB.FleetFeedback(
            device_kind=self.cfg.device_kind or "unknown",
            topology=self.cfg.topology, p=self.cfg.n_replicas,
            provenance=prov)
        for rep in self.replicas:
            ticks = self._tick_log[rep.rid]
            fb.replicas[str(rep.rid)] = FB.replica_stats(
                ticks, self.router.latency[rep.rid])
        # request-level tail latency (p50/p99 ticks), not just the EWMA
        fb.latency["requests"] = latency_summary(self.request_latencies())
        return fb

    def save_feedback(self, timestamp: Optional[str] = None,
                      provenance: Optional[Dict[str, Optional[str]]] = None
                      ) -> str:
        if self.cfg.device_kind is None:
            raise ValueError(
                "FleetConfig.device_kind is unset; feedback persistence "
                "needs the (device_kind, topology, p) store key")
        return FB.save_feedback(self.feedback(timestamp, provenance),
                                dir=self.cfg.feedback_dir)
