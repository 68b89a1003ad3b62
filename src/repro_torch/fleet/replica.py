"""One serve replica behind a uniform tick interface, with drain/respawn.

Port of ``repro.fleet.replica``.  A :class:`Replica` wraps a
``ContinuousBatchingScheduler`` (its own KV pool, slot allocator, and
virtual clock) over *shared* engine entry points — N data-parallel
replicas of the same model share one ``serve.engine.ServeFns`` and one
copy of the weights and hold N pools (the reference compiles once and
holds N pools).  The fleet loop drives every replica through
``tick(now)``: replica clocks are pinned to the fleet clock each tick, so
per-request latency stats stay in fleet ticks across drains and
respawns.

Lifecycle::

    ACTIVE ── drain() ──▶ DRAINING ── in-flight retires ──▶ STOPPED
      ▲        (ejects un-admitted requests for re-routing;              │
      │         admitted ones keep decoding to completion)               │
      ├── crash() ── unplanned stop: ejects waiting AND in-flight ───────┤
      │   (in-flight prepared for replay — see                           │
      │    ``ContinuousBatchingScheduler.eject_all``)                    │
      └─────────────────────── respawn() ◀───────────────────────────────┘
                        (fresh scheduler + pool, same engine)

Because pages are computationally independent and each sampling stream
is keyed per (request, token-index), a drain/respawn does not change any
request's token stream: ejected requests replay identically wherever the
router lands them, and in-flight requests finish exactly where they are
(on the card, up to the floating-point differences of another pool size:
``serve.scheduler``).

The measured tick latency is the ``timer()`` pair around
``sched.step()``.  It includes the device's work without a
``torch.cuda.synchronize``: the sampler copies each step's tokens to the
host, which waits for the step's kernels.  The page evictions that follow
a retirement are queued after that copy and land in the next tick's
measurement.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

ACTIVE = "active"
DRAINING = "draining"
STOPPED = "stopped"


@dataclass(frozen=True)
class TickReport:
    """What one ``tick(now)`` did: whether the scheduler stepped, the
    measured wall latency of that step (the router feedback signal), and
    how many tokens it produced."""
    replica: int
    worked: bool
    latency_s: float
    tokens: int


class Replica:
    """A ``ContinuousBatchingScheduler`` the fleet can tick, drain, and
    respawn (``fns`` a ``serve.engine.ServeFns``, shared across replicas).  ``timer`` is injectable (tests feed deterministic clocks);
    it defaults to ``time.perf_counter`` — *measured* latency, not the
    virtual clock."""

    def __init__(self, rid: int, model_cfg, fns, params, n_slots: int,
                 max_seq_len: int, top_k: int = 0, top_p: float = 0.0,
                 seed: int = 0,
                 timer: Callable[[], float] = time.perf_counter):
        self.rid = rid
        self._args = (model_cfg, fns, params, n_slots, max_seq_len,
                      top_k, top_p, seed)
        self.timer = timer
        self.state = ACTIVE
        self.n_respawns = 0
        self.n_crashes = 0
        #: armed fault (chaos injection): raised by the NEXT tick, mid-tick
        self._fault: Optional[BaseException] = None
        #: one-tick measured-latency multiplier (chaos straggler); the
        #: supervisor arms it and it disarms itself after one worked tick
        self.latency_scale = 1.0
        #: latency records + token counts retired by *previous*
        #: incarnations (a respawn replaces the scheduler, not history)
        self._done_latencies: List[Dict[str, float]] = []
        self._done_tokens = 0
        self._done_steps = 0
        self.sched = self._new_sched()

    def _new_sched(self) -> ContinuousBatchingScheduler:
        cfg, fns, params, n_slots, S, top_k, top_p, seed = self._args
        return ContinuousBatchingScheduler(
            cfg, fns, params, n_slots, S, top_k=top_k, top_p=top_p,
            seed=seed)

    # -- routing-facing view -------------------------------------------------

    @property
    def load(self) -> int:
        """Queued + running requests (the router's load metric)."""
        return self.sched.n_running + self.sched.n_waiting

    @property
    def has_work(self) -> bool:
        return self.load > 0

    def submit(self, req: Request) -> None:
        if self.state != ACTIVE:
            raise ValueError(
                f"replica {self.rid} is {self.state}; only ACTIVE replicas "
                f"admit requests")
        self.sched.submit(req)

    # -- the tick ------------------------------------------------------------

    def tick(self, now: float) -> TickReport:
        """Advance one scheduler step at fleet time ``now``.  A DRAINING
        replica keeps ticking until its in-flight requests retire, then
        releases (STOPPED).  Idle replicas report no work (and no
        latency sample — an empty step would poison the EWMA)."""
        if self.state == STOPPED or not self.has_work:
            if self.state == DRAINING and not self.has_work:
                self.state = STOPPED
            return TickReport(self.rid, False, 0.0, 0)
        if self._fault is not None:
            fault, self._fault = self._fault, None
            raise fault
        self.sched.clock = float(now)
        before = self.sched.tokens_out
        t0 = self.timer()
        self.sched.step()
        dt = self.timer() - t0
        scale, self.latency_scale = self.latency_scale, 1.0
        if self.state == DRAINING and not self.has_work:
            self.state = STOPPED
        return TickReport(self.rid, True, max(dt, 0.0) * scale,
                          self.sched.tokens_out - before)

    # -- elasticity ----------------------------------------------------------

    def drain(self) -> List[Request]:
        """Stop admitting: eject the un-admitted queue (the fleet
        re-routes it) and let in-flight requests finish over subsequent
        ticks.  Idempotent; returns the displaced requests."""
        if self.state == STOPPED:
            return []
        self.state = DRAINING
        displaced = self.sched.eject_waiting()
        if not self.has_work:
            self.state = STOPPED
        return displaced

    def inject_fault(self, exc: BaseException) -> None:
        """Arm ``exc`` to be raised by the next tick that would have
        stepped the scheduler — the chaos crash-mid-tick injection point.
        The exception surfaces through ``Fleet.step``'s tick loop exactly
        like an engine error would, so the supervisor's recovery path
        is exercised for real, not simulated."""
        self._fault = exc

    def crash(self) -> List[Request]:
        """Unplanned stop: eject the waiting queue AND the in-flight
        requests (prepared for replay — see
        ``ContinuousBatchingScheduler.eject_all``), retire this
        incarnation's accounting, and go STOPPED without draining.
        ``respawn`` brings the replica back with a fresh scheduler."""
        if self.state == STOPPED:
            return []
        displaced = self.sched.eject_all()
        # accounting stays on the dead scheduler until ``respawn``
        # harvests it — tokens_out/request_latencies keep reading through
        self.state = STOPPED
        self.n_crashes += 1
        return displaced

    def respawn(self) -> None:
        """Fresh scheduler + pool over the same engine fns; the
        replica rejoins the healthy set.  Latency/token history from the
        retired incarnation is preserved for fleet stats."""
        if self.state != STOPPED:
            raise ValueError(
                f"replica {self.rid} is {self.state}; drain to STOPPED "
                f"before respawning")
        self._done_latencies.extend(self.sched.request_latencies())
        self._done_tokens += self.sched.tokens_out
        self._done_steps += self.sched.alloc.decode_steps
        self.sched = self._new_sched()
        self.state = ACTIVE
        self.n_respawns += 1

    # -- accounting ----------------------------------------------------------

    @property
    def tokens_out(self) -> int:
        return self._done_tokens + self.sched.tokens_out

    @property
    def decode_steps(self) -> int:
        return self._done_steps + self.sched.alloc.decode_steps

    def request_latencies(self) -> List[Dict[str, float]]:
        """Per-request latency records across every incarnation."""
        return self._done_latencies + self.sched.request_latencies()
