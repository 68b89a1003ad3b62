"""Session/prefix-affinity request routing with least-loaded spill.

Port of ``repro.fleet.router``: pure host code, so its decisions equal the
reference's on the same inputs.

Affinity first: a request's key (its session id, else a hash of the
prompt's leading tokens — so identical prefixes co-locate) picks a
preferred replica by rendezvous (highest-random-weight) hashing, which
keeps the key->replica mapping stable when replicas drain in or out:
only keys owned by the departed replica move.  KV/prefix reuse therefore
survives elasticity events instead of reshuffling the whole fleet.

Load second: affinity is overridden only when the preferred replica is
measurably behind — its *effective load* (queued + running requests,
weighted by the measured EWMA tick latency the fleet feeds back through
:mod:`repro_torch.fleet.feedback`) exceeds the fleet minimum by more than
``spill_slack`` requests.  Spills go to the least-loaded replica, ties
broken by rendezvous order so the choice is deterministic.

Everything here is pure host-side bookkeeping: same inputs (trace, seed,
measured latencies) => same decisions.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Sequence

from repro_torch.fleet.feedback import EWMA_ALPHA, Ewma

#: prompt tokens hashed when a request carries no session id — long
#: enough to separate workloads, short enough that shared system prompts
#: land on the same replica
PREFIX_TOKENS = 16


def affinity_key(req) -> str:
    """The routing key: session id when present, else the prompt's
    leading-token hash (prefix affinity for KV/prefix-cache reuse)."""
    if getattr(req, "session", None):
        return f"session:{req.session}"
    prefix = bytes(int(t) & 0xFF for t in req.prompt[:PREFIX_TOKENS])
    return "prefix:" + hashlib.blake2b(prefix, digest_size=8).hexdigest()


def _weight(key: str, replica: int) -> int:
    """Rendezvous weight of (key, replica): stable across processes (no
    PYTHONHASHSEED dependence) and uniform enough at fleet sizes."""
    h = hashlib.blake2b(f"{key}|{replica}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


@dataclass(frozen=True)
class RouteDecision:
    replica: int
    preferred: int
    key: str
    spilled: bool


@dataclass
class AffinityRouter:
    """Routes requests over a fixed replica-id universe; the *healthy*
    subset (ACTIVE replicas) is passed per call so drains/respawns take
    effect immediately."""

    replica_ids: Sequence[int]
    #: affinity yields to load only past this many extra queued requests
    #: on the preferred replica (default: one pool's worth, set by Fleet)
    spill_slack: int = 4
    ewma_alpha: float = EWMA_ALPHA
    #: measured per-replica EWMA tick latency (seconds); warm-startable
    #: from a persisted FleetFeedback, updated live via observe()
    latency: Dict[int, Ewma] = field(default_factory=dict)
    n_routed: int = 0
    n_spilled: int = 0
    per_replica: Dict[int, int] = field(default_factory=dict)

    def __post_init__(self):
        self.replica_ids = tuple(self.replica_ids)
        for r in self.replica_ids:
            self.latency.setdefault(r, Ewma(alpha=self.ewma_alpha))
            self.per_replica.setdefault(r, 0)

    # -- measured-latency feedback ------------------------------------------

    def warm_start(self, prior: Dict[int, float]) -> None:
        """Seed the EWMAs from a persisted feedback set (ids not in this
        fleet are ignored; the first live observation then updates from
        the prior instead of resetting to it)."""
        for r, v in prior.items():
            if r in self.latency and v > 0:
                self.latency[r].update(v)

    def observe(self, replica: int, tick_latency_s: float) -> None:
        """Feed one measured tick latency into the replica's EWMA."""
        self.latency[replica].update(tick_latency_s)

    def reset(self, replica: int) -> None:
        """Forget a replica's measured latency (a respawned incarnation
        is a new host as far as the EWMA is concerned — the supervisor
        calls this so a straggler-poisoned estimate does not outlive the
        crash that evicted it)."""
        self.latency[replica] = Ewma(alpha=self.ewma_alpha)

    def _latency_weight(self, replica: int, healthy: Sequence[int]) -> float:
        """EWMA latency relative to the fastest healthy replica (1.0 when
        nothing is measured yet): a replica ticking 2x slower counts each
        queued request double."""
        measured = [self.latency[r].value for r in healthy
                    if self.latency[r].count > 0]
        mine = self.latency[replica]
        if not measured or mine.count == 0:
            return 1.0
        fastest = min(measured)
        if fastest <= 0:
            return 1.0
        return mine.value / fastest

    # -- routing -------------------------------------------------------------

    def route(self, req, healthy: Sequence[int],
              loads: Dict[int, int]) -> RouteDecision:
        """Pick a replica for ``req``.  ``healthy`` is the ACTIVE subset
        (order-insensitive), ``loads`` the queued+running request count
        per replica."""
        healthy = sorted(healthy)
        if not healthy:
            raise ValueError("no healthy replicas to route to")
        key = affinity_key(req)
        ranked = sorted(healthy, key=lambda r: (-_weight(key, r), r))
        preferred = ranked[0]
        eff = {r: loads.get(r, 0) * self._latency_weight(r, healthy)
               for r in healthy}
        floor = min(eff.values())
        target, spilled = preferred, False
        if eff[preferred] > floor + self.spill_slack:
            # least effective load, ties toward rendezvous preference
            target = min(ranked, key=lambda r: (eff[r], ranked.index(r)))
            spilled = target != preferred
        self.n_routed += 1
        self.n_spilled += int(spilled)
        self.per_replica[target] = self.per_replica.get(target, 0) + 1
        return RouteDecision(replica=target, preferred=preferred, key=key,
                             spilled=spilled)

    def snapshot(self) -> Dict[str, object]:
        """Routing counters + current EWMAs (for stats/benchmarks)."""
        return {
            "n_routed": self.n_routed,
            "n_spilled": self.n_spilled,
            "per_replica": dict(sorted(self.per_replica.items())),
            "ewma_tick_s": {r: self.latency[r].value
                            for r in self.replica_ids
                            if self.latency[r].count > 0},
        }
