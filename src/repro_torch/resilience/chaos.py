"""Deterministic, seed-driven fault injection.

Port of ``repro.resilience.chaos``: the same event specs, and the same
schedule from the same seed (``np.random.RandomState``).

Every fault the resilience layer can inject is a scheduled
:class:`FaultEvent` — ``(tick, kind, target, magnitude)`` — so a chaos
run is a pure function of its event list (and the event list itself is a
pure function of ``--chaos-seed`` when generated): two runs with the
same schedule inject byte-identical faults at the same virtual ticks.
Nothing here reads a wall clock or an unseeded RNG.

Kinds
  crash          : the target replica's next tick raises mid-tick (the
                   supervisor's unplanned-exception path, not a drain)
  straggler      : the target replica's next measured tick latency is
                   scaled by ``magnitude`` (poisons the router EWMA the
                   way a slow host would; token streams must not change)
  link_slow      : the topology cost model's global links degrade by
                   ``magnitude`` (``degraded_topology`` scales beta —
                   re-pricing, not re-execution: the decision tables see
                   a slower global tier)
  rank_loss      : ``magnitude`` DP ranks die at train step ``tick``
                   (bridged to ``train.runtime.FailureInjector`` /
                   ``resilience.elastic``)
  corrupt_store  : a measurement/feedback JSON store file is overwritten
                   with seed-derived garbage (exercises the quarantine
                   paths in ``tuner.store`` / ``fleet.feedback``)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

CHAOS_KINDS = ("crash", "straggler", "link_slow", "rank_loss",
               "corrupt_store")

#: kinds the fleet supervisor applies per tick (the serve-side subset)
FLEET_KINDS = ("crash", "straggler")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``tick`` is the fleet tick (serve-side
    kinds) or the train step (``rank_loss``); ``target`` is the replica
    id / first lost rank; ``magnitude`` is the kind's scale factor
    (straggler latency multiple, link beta multiple, ranks lost)."""
    tick: int
    kind: str
    target: int = 0
    magnitude: float = 1.0

    def __post_init__(self):
        if self.kind not in CHAOS_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {CHAOS_KINDS}")
        if self.tick < 0:
            raise ValueError(f"fault tick must be >= 0, got {self.tick}")
        if self.magnitude <= 0:
            raise ValueError(
                f"fault magnitude must be > 0, got {self.magnitude}")

    def spec(self) -> str:
        """The CLI spec string this event round-trips through."""
        return f"{self.tick}:{self.kind}:{self.target}:{self.magnitude:g}"


def parse_event(spec: str) -> FaultEvent:
    """Parse a ``TICK:KIND:TARGET[:MAGNITUDE]`` CLI spec
    (``launch/fleet.py --chaos-events``)."""
    parts = spec.split(":")
    if len(parts) not in (3, 4):
        raise ValueError(
            f"chaos event spec {spec!r} is not TICK:KIND:TARGET[:MAGNITUDE]")
    mag = float(parts[3]) if len(parts) == 4 else 1.0
    return FaultEvent(int(parts[0]), parts[1], int(parts[2]), mag)


def generate_events(seed: int, n_ticks: int, n_replicas: int,
                    n_events: int = 2,
                    kinds: Sequence[str] = FLEET_KINDS,
                    straggler_scale: float = 4.0) -> Tuple[FaultEvent, ...]:
    """Seed-driven event list: ``n_events`` faults drawn uniformly over
    ticks ``[1, n_ticks)`` x replicas x ``kinds``.  Same seed, same
    arguments -> the identical schedule, every time."""
    for k in kinds:
        if k not in CHAOS_KINDS:
            raise ValueError(f"unknown fault kind {k!r}")
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_events):
        kind = kinds[int(rng.randint(len(kinds)))]
        out.append(FaultEvent(
            tick=int(rng.randint(1, max(2, n_ticks))),
            kind=kind,
            target=int(rng.randint(n_replicas)),
            magnitude=straggler_scale if kind == "straggler" else 1.0))
    return tuple(sorted(out, key=lambda e: (e.tick, e.kind, e.target)))


class ChaosSchedule:
    """An immutable, tick-indexed view over a fault-event list."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.tick, e.kind, e.target)))
        self._by_tick: Dict[int, List[FaultEvent]] = {}
        for ev in self.events:
            self._by_tick.setdefault(ev.tick, []).append(ev)

    def at(self, tick: int) -> Tuple[FaultEvent, ...]:
        return tuple(self._by_tick.get(tick, ()))

    def of_kind(self, *kinds: str) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind in kinds)

    @property
    def last_tick(self) -> int:
        return self.events[-1].tick if self.events else -1

    def signature(self) -> str:
        """Human/log-friendly one-liner; also the reproduction recipe."""
        return " ".join(e.spec() for e in self.events) or "(none)"


# ---------------------------------------------------------------------------
# Appliers
# ---------------------------------------------------------------------------

def degraded_topology(topo, beta_scale: float, alpha_scale: float = 1.0):
    """The cost model's view of a global-link slowdown (the ``link_slow``
    fault kind): a new frozen topo with the slow tier ``beta_scale``x
    slower.  Delegates to
    :func:`repro_torch.topology.cost.degrade_topology` —
    the cost model and decision tables are pure in the topo argument, so
    re-pricing a degraded network is just passing the result in
    (``cost.predict_time``, ``table.build_table``)."""
    from repro_torch.topology.cost import degrade_topology
    return degrade_topology(topo, beta_scale, alpha_scale=alpha_scale)


def corrupt_file(path: str, seed: int = 0, nbytes: int = 64) -> str:
    """Overwrite ``path`` with seed-derived garbage (same seed, same
    garbage).  The write is deliberately NOT atomic — a torn write is
    exactly the failure the store quarantine paths must absorb."""
    rng = np.random.RandomState(seed)
    garbage = bytes(bytearray(rng.randint(0, 256, size=nbytes, dtype=np.uint8)))
    with open(path, "wb") as f:
        f.write(b"{corrupt" + garbage)
    return path


def rank_loss_schedule(events: Sequence[FaultEvent]) -> Dict[int, bool]:
    """Bridge ``rank_loss`` events to ``train.runtime.FailureInjector``'s
    ``{step: permanent}`` schedule (rank loss is always permanent — the
    transient-restart path keeps the same rank count)."""
    return {e.tick: True for e in events if e.kind == "rank_loss"}


def lost_ranks(events: Sequence[FaultEvent], step: int) -> Tuple[int, ...]:
    """The ranks a ``rank_loss`` event at ``step`` removes:
    ``magnitude`` consecutive ranks starting at ``target``."""
    for e in events:
        if e.kind == "rank_loss" and e.tick == step:
            k = int(e.magnitude)
            return tuple(range(e.target, e.target + k))
    return ()
