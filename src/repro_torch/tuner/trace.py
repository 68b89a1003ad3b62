"""Schedule-replay link tracer: per-link byte counters for any schedule.

The port's copy of ``repro.tuner.trace`` (numpy-free, on the port's
``core.schedules`` and ``core.traffic``); ``obs.collect`` replays through
it.
``core.traffic`` *counts* global bytes in closed form (one pass over the
schedule, summing the messages that cross a group boundary).  This module
*replays* the schedule message by message onto the topology and maintains
a per-link byte counter — the measured-traffic view the paper reports —
so the closed-form counts can be verified from an independent accounting
of the same wire steps, and per-link hotspots become visible.

Link model:
  * grouped topologies — every intra-group message charges the direct
    (src_node, dst_node) local link; every inter-group message charges
    the (src_group, dst_group) global link (minimal inter-group routing,
    the paper's lower-bound convention);
  * torus — every message is routed dimension-ordered along the minimal
    path (ties toward the positive direction) and charges each physical
    directed link (node, next_node) it traverses, so the counter total
    equals ``core.traffic.hop_bytes`` exactly.

Byte values are exact for power-of-two ``vec_bytes`` and ``p`` (every
per-message size is then an exact binary float), which is what the
conformance tests rely on when asserting replayed == closed-form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.schedules import Sched, get_schedule
from repro_torch.core.traffic import GroupedTopo, TorusTopo, msg_bytes

#: a directed link: (src, dst) node ids — or group ids for global links
Link = Tuple[int, int]


@dataclass
class TraceResult:
    """Replayed per-link byte counters for one schedule on one topology."""
    topology: str
    kind: str                       # "grouped" | "torus"
    p: int
    vec_bytes: float
    #: directed local links (grouped: node->node same group;
    #: torus: physical hop links) -> bytes carried
    link_bytes: Dict[Link, float] = field(default_factory=dict)
    #: grouped only: directed (src_group, dst_group) -> bytes crossing
    global_link_bytes: Dict[Link, float] = field(default_factory=dict)
    #: per step: (local bytes, global bytes) — torus: (link bytes, 0)
    steps: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def local_bytes(self) -> float:
        return sum(b for b, _ in self.steps)

    @property
    def global_bytes(self) -> float:
        """Σ over the global-link counters (grouped; 0.0 on a torus)."""
        return sum(b for _, b in self.steps)

    @property
    def hop_bytes(self) -> float:
        """Σ bytes over all physical links (torus link-load total)."""
        return sum(self.link_bytes.values())

    @property
    def total_bytes(self) -> float:
        return self.local_bytes + self.global_bytes


def _grouped_replay(sched: Sched, p: int, vec_bytes: float,
                    topo: GroupedTopo,
                    placement: Optional[Sequence[int]]) -> TraceResult:
    place = (lambda r: r) if placement is None else (lambda r: placement[r])
    res = TraceResult(topology=topo.name, kind="grouped", p=p,
                      vec_bytes=vec_bytes)
    for step in sched:
        loc = glo = 0.0
        for m in step:
            b = msg_bytes(m, p, vec_bytes)
            u, v = place(m.src), place(m.dst)
            gu, gv = topo.group_of(u), topo.group_of(v)
            if gu == gv:
                res.link_bytes[(u, v)] = res.link_bytes.get((u, v), 0.0) + b
                loc += b
            else:
                key = (gu, gv)
                res.global_link_bytes[key] = \
                    res.global_link_bytes.get(key, 0.0) + b
                glo += b
        res.steps.append((loc, glo))
    return res


def _torus_route(topo: TorusTopo, a: int, b: int):
    """Dimension-ordered minimal route a -> b as a list of node ids.

    Per dimension, take the shorter wrap direction; exact ties (delta ==
    dim - delta) go positive — either choice traverses ``min(delta,
    d-delta)`` links, so the hop count (and hence the byte total) always
    matches ``TorusTopo.hops``.
    """
    ca, cb = list(topo.coords(a)), topo.coords(b)
    path = []
    node = a

    def to_id(coords):
        out = 0
        for c, d in zip(coords, topo.dims):
            out = out * d + c
        return out

    for i, d in enumerate(topo.dims):
        fwd = (cb[i] - ca[i]) % d
        bwd = (ca[i] - cb[i]) % d
        step = 1 if fwd <= bwd else -1
        for _ in range(min(fwd, bwd)):
            ca[i] = (ca[i] + step) % d
            nxt = to_id(ca)
            path.append((node, nxt))
            node = nxt
    return path


def _torus_replay(sched: Sched, p: int, vec_bytes: float, topo: TorusTopo,
                  placement: Optional[Sequence[int]]) -> TraceResult:
    place = (lambda r: r) if placement is None else (lambda r: placement[r])
    res = TraceResult(topology=topo.name, kind="torus", p=p,
                      vec_bytes=vec_bytes)
    for step in sched:
        moved = 0.0
        for m in step:
            b = msg_bytes(m, p, vec_bytes)
            for u, v in _torus_route(topo, place(m.src), place(m.dst)):
                res.link_bytes[(u, v)] = res.link_bytes.get((u, v), 0.0) + b
                moved += b
        res.steps.append((moved, 0.0))
    return res


def trace_schedule(sched: Sched, p: int, vec_bytes: float,
                   topo: Union[GroupedTopo, TorusTopo],
                   placement: Optional[Sequence[int]] = None) -> TraceResult:
    """Replay ``sched`` on ``topo`` and return the per-link byte counters.

    ``placement[r]`` maps rank ``r`` to a node id (identity when absent,
    the same convention as ``core.traffic``).
    """
    if isinstance(topo, TorusTopo):
        return _torus_replay(sched, p, vec_bytes, topo, placement)
    return _grouped_replay(sched, p, vec_bytes, topo, placement)


def trace_collective(collective: str, algo: str, p: int, vec_bytes: float,
                     topo: Union[GroupedTopo, TorusTopo],
                     placement: Optional[Sequence[int]] = None,
                     root: int = 0) -> TraceResult:
    """``trace_schedule`` of a registry schedule (``core.schedules``)."""
    return trace_schedule(get_schedule(collective, algo, p, root), p,
                          vec_bytes, topo, placement)


def replayed_reduction(collective: str, algo_bine: str, algo_base: str,
                       p: int, vec_bytes: float, topo: GroupedTopo,
                       placement: Optional[Sequence[int]] = None,
                       root: int = 0) -> float:
    """(base - bine) / base global bytes, from REPLAYED link counters.

    The measured-traffic analogue of ``core.traffic.traffic_reduction`` —
    the paper's headline metric, recomputed from per-step per-link
    accounting rather than the closed-form sum.
    """
    gb = trace_collective(collective, algo_bine, p, vec_bytes, topo,
                          placement, root).global_bytes
    ga = trace_collective(collective, algo_base, p, vec_bytes, topo,
                          placement, root).global_bytes
    if ga == 0:
        return 0.0
    return (ga - gb) / ga


def spread_placement(p: int, topo: GroupedTopo, per_group: int):
    """Block placement with ``per_group`` ranks per group — the scenario
    where group occupancy is NOT a power of two (the paper's real systems:
    LUMI 124, Leonardo 180, MN5 160 nodes/group) and Bine's negabinary
    distance profile crosses fewer group boundaries than XOR partnering.
    """
    if per_group > topo.group_size:
        raise ValueError(f"per_group {per_group} > group size "
                         f"{topo.group_size}")
    return [(r // per_group) * topo.group_size + (r % per_group)
            for r in range(p)]


def hier_global_cut(collective: str, p: int, vec_bytes: float,
                    topo: GroupedTopo,
                    tiers: Optional[Sequence[int]] = None,
                    algo: str = "bine",
                    flat_algo: str = "bine") -> Tuple[float, float]:
    """(hier global bytes, flat global bytes) under tier-aligned spread
    placement — the replayed evidence that a composed hierarchy keeps the
    inner phases off the global links.

    Replays ``compose(collective, tiers, algo)`` (default: the balanced
    ``default_tiers`` split) and the flat ``flat_algo`` schedule with
    ``spread_placement(..., per_group=tiers[0])`` — one innermost subgroup
    per group — and cross-checks the replayed hierarchical counter against
    the closed form ``core.traffic.compose_global_bytes`` before returning
    it.  The hierarchy's outer phases are its only crossing traffic, so
    for any depth ≥ 2 the first value is strictly below the second.
    """
    from repro_torch.core.schedules import compose, default_tiers
    from repro_torch.core.traffic import compose_global_bytes

    tiers = tuple(int(t) for t in tiers) if tiers is not None \
        else default_tiers(p)
    placement = spread_placement(p, topo, per_group=tiers[0])
    hier = trace_schedule(compose(collective, tiers, algo), p, vec_bytes,
                          topo, placement)
    flat = trace_collective(collective, flat_algo, p, vec_bytes, topo,
                            placement)
    closed = compose_global_bytes(collective, tiers, vec_bytes, tiers[0],
                                  algo)
    assert hier.global_bytes == closed, (
        "replayed hierarchical global bytes disagree with the closed form",
        hier.global_bytes, closed, collective, tiers)
    return hier.global_bytes, flat.global_bytes
