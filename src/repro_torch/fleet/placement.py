"""Topology-aware placement of N tensor-parallel serve replicas.

Port of ``repro.fleet.placement`` on the port's copies of the cost model
(``core.traffic``, ``core.schedules``, ``topology``): the same scores to
the bit and the same ``format_plan`` text.

A fleet allocation is a set of rank slots the machine scheduler handed the
job — on grouped topologies typically *spread across several groups*
(exactly the regime of the paper's Fig. 5 allocation sampling).  Placement
decides which replica's TP group runs on which slots.  The locality
principle from the collective layer applies unchanged one level up: every
decode step runs the TP collectives (flash-decoding partial-softmax
allreduce, vocab logits allgather — the same payloads
``serve.engine.collective_plan`` prices), so a TP group that spans a group
boundary pays global-link bytes on *every tick*.

Two candidate strategies are scored with the ``repro_torch.topology`` cost
model and the cheapest wins:

  * ``contiguous``   — pack each replica's TP ranks onto consecutive
    slots (group-sorted on grouped presets; dimension-contiguous
    sub-blocks on the torus, where row-major node order makes contiguous
    slot chunks contiguous in the trailing torus dimensions);
  * ``round_robin``  — the naive default (replica ``i`` takes slots
    ``i, i+R, i+2R, ...``), which stripes every TP group across the
    allocation.

Grouped presets derive their hierarchy through
``topology.tier_split_or_none``; the torus (``None``) takes the
dimension-contiguous fallback instead of the ``tier_split`` raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.traffic import (TorusTopo, global_bytes, hop_bytes,
                                      sched_time, torus_time, total_bytes)
from repro_torch.core.schedules import get_schedule
from repro_torch.topology.cost import schedule_algo
from repro_torch.topology.presets import (GROUPED_PRESETS, get_topology,
                                          tier_split_or_none, torus_dims)

#: strategy evaluation order — doubles as the tie-break (earlier wins)
STRATEGIES = ("contiguous", "round_robin")

#: decode-step collectives a placement is scored on, keyed like
#: ``serve.engine.collective_plan``
Payloads = Tuple[Tuple[str, float], ...]


@dataclass(frozen=True)
class PlacementScore:
    """Predicted per-decode-step traffic of one placement strategy."""
    strategy: str
    #: bytes crossing group boundaries (grouped) / Σ bytes·hops (torus)
    #: summed over replicas — the fleet's per-tick global-link load
    global_bytes: float
    #: bytes staying inside groups (grouped; 0.0 on the torus, where
    #: hop-bytes already weights every link)
    local_bytes: float
    #: α-β predicted tick time: replicas tick concurrently, so the fleet
    #: pays the slowest replica's decode-step collectives
    tick_time_s: float


@dataclass(frozen=True)
class PlacementPlan:
    """Scored placement candidates for one fleet shape on one preset."""
    preset: str
    n_ranks: int
    n_replicas: int
    tp: int
    #: ranks per group of the modeled allocation (grouped presets only)
    per_group: Optional[int]
    #: ``tier_split_or_none`` result (None on the torus)
    tiers: Optional[Tuple[int, ...]]
    #: torus dims of the allocation (torus only)
    dims: Optional[Tuple[int, ...]]
    #: node id of every rank slot
    allocation: Tuple[int, ...]
    #: strategy -> per-replica node ids
    placements: Dict[str, Tuple[Tuple[int, ...], ...]]
    scores: Dict[str, PlacementScore]
    chosen: str

    @property
    def replica_nodes(self) -> Tuple[Tuple[int, ...], ...]:
        return self.placements[self.chosen]


def fleet_allocation(preset: str, n_ranks: int,
                     per_group: Optional[int] = None) -> Tuple[int, ...]:
    """Node id per rank slot of a deterministic modeled allocation.

    Grouped presets: ``per_group`` consecutive rank slots per group
    (groups in order, ``node_size`` ranks filling each node) — the
    block-sorted shape real schedulers hand out ("sort ranks by
    hostname").  Torus: the whole ``torus_dims(n_ranks)`` machine in
    row-major node order.
    """
    if tier_split_or_none(preset, max(n_ranks, 1)) is None:
        return tuple(range(n_ranks))
    topo = GROUPED_PRESETS[preset]
    pg = per_group if per_group is not None else n_ranks
    cap = topo.group_size * topo.node_size
    if not 1 <= pg <= cap:
        raise ValueError(
            f"per_group={pg} outside [1, {cap}] "
            f"(= group_size x node_size on {preset})")
    return tuple((k // pg) * topo.group_size + (k % pg) // topo.node_size
                 for k in range(n_ranks))


def contiguous_placement(n_ranks: int, n_replicas: int,
                         tp: int) -> Tuple[Tuple[int, ...], ...]:
    """Replica ``i`` takes slots ``[i*tp, (i+1)*tp)`` — group-packed on
    grouped allocations, dimension-contiguous sub-blocks on the torus."""
    _check_shape(n_ranks, n_replicas, tp)
    return tuple(tuple(range(i * tp, (i + 1) * tp))
                 for i in range(n_replicas))


def round_robin_placement(n_ranks: int, n_replicas: int,
                          tp: int) -> Tuple[Tuple[int, ...], ...]:
    """The naive stripe: replica ``i`` takes slots ``i, i+R, i+2R, ...``"""
    _check_shape(n_ranks, n_replicas, tp)
    return tuple(tuple(i + j * n_replicas for j in range(tp))
                 for i in range(n_replicas))


def _check_shape(n_ranks: int, n_replicas: int, tp: int) -> None:
    if n_replicas < 1 or tp < 1:
        raise ValueError(f"need n_replicas >= 1 and tp >= 1, got "
                         f"{n_replicas}, {tp}")
    if n_replicas * tp > n_ranks:
        raise ValueError(
            f"{n_replicas} replicas x tp={tp} exceed the allocation's "
            f"{n_ranks} rank slots")


def decode_payloads(n_slots: int, n_heads: int, head_dim: int,
                    vocab_size: int, itemsize: int = 2) -> Payloads:
    """Per-decode-step TP collective payloads (bytes), mirroring
    ``serve.engine.collective_plan``: the flash-decoding partial-softmax
    allreduce over the attention output and the float32 vocab-sharded
    logits allgather, both over the whole ``n_slots`` pool."""
    return (
        ("allreduce", float(n_slots * n_heads * head_dim * itemsize)),
        ("allgather", float(n_slots * vocab_size * 4)),
    )


def score_placement(preset: str, allocation: Sequence[int],
                    replica_slots: Sequence[Sequence[int]], tp: int,
                    payloads: Payloads,
                    strategy: str = "explicit") -> PlacementScore:
    """Price one placement: per replica, replay each decode-step
    collective's bine schedule at radix ``tp`` onto the replica's nodes
    and split the wire bytes into group-crossing vs intra-group (grouped)
    or weight them by hops (torus).  Replicas run concurrently, so bytes
    sum (link load) while time takes the slowest replica."""
    topo = get_topology(preset, len(allocation))
    glob = loc = 0.0
    tick = 0.0
    for slots in replica_slots:
        if len(slots) != tp:
            raise ValueError(f"replica holds {len(slots)} slots, tp={tp}")
        nodes = [allocation[s] for s in slots]
        r_time = 0.0
        for coll, nbytes in payloads:
            if tp == 1:
                continue
            sched_coll, algo = schedule_algo(coll, "bine", nbytes)
            sched = get_schedule(sched_coll, algo, tp)
            if isinstance(topo, TorusTopo):
                glob += hop_bytes(sched, tp, nbytes, topo, nodes)
                r_time += torus_time(sched, tp, nbytes, topo, nodes)
            else:
                g = global_bytes(sched, tp, nbytes, topo, nodes)
                glob += g
                loc += total_bytes(sched, tp, nbytes) - g
                r_time += sched_time(sched, tp, nbytes, topo, nodes)
        tick = max(tick, r_time)
    return PlacementScore(strategy=strategy, global_bytes=glob,
                          local_bytes=loc, tick_time_s=tick)


def plan_placement(preset: str, n_ranks: int, n_replicas: int, tp: int,
                   payloads: Payloads,
                   per_group: Optional[int] = None) -> PlacementPlan:
    """Score every strategy for one fleet shape and pick the cheapest.

    ``per_group`` shapes the modeled grouped allocation; the default puts
    one TP group's worth of ranks per group when the fleet has several
    replicas (the spread allocation schedulers actually hand out), and
    the whole job in one group for a single replica.  Argmin over
    ``(global_bytes, tick_time_s)`` with ties broken toward the earlier
    strategy — exactly the decision-table convention.
    """
    tiers = tier_split_or_none(preset, tp)
    if tiers is None:
        per_group = None
        dims = torus_dims(n_ranks)
    else:
        dims = None
        if per_group is None:
            per_group = tp if n_replicas > 1 else n_ranks
    allocation = fleet_allocation(preset, n_ranks, per_group)
    builders = {"contiguous": contiguous_placement,
                "round_robin": round_robin_placement}
    placements: Dict[str, Tuple[Tuple[int, ...], ...]] = {}
    scores: Dict[str, PlacementScore] = {}
    for strat in STRATEGIES:
        slots = builders[strat](n_ranks, n_replicas, tp)
        placements[strat] = tuple(
            tuple(allocation[s] for s in rs) for rs in slots)
        scores[strat] = score_placement(preset, allocation, slots, tp,
                                        payloads, strategy=strat)
    chosen = min(STRATEGIES,
                 key=lambda s: (scores[s].global_bytes,
                                scores[s].tick_time_s,
                                STRATEGIES.index(s)))
    return PlacementPlan(preset=preset, n_ranks=n_ranks,
                         n_replicas=n_replicas, tp=tp, per_group=per_group,
                         tiers=tiers, dims=dims,
                         allocation=tuple(allocation),
                         placements=placements, scores=scores,
                         chosen=chosen)


def format_plan(plan: PlacementPlan) -> str:
    """Human-readable placement report (the ``launch.fleet --dryrun``
    output CI smokes over every packaged preset)."""
    hier = (f"tiers={plan.tiers}" if plan.tiers is not None
            else f"dims={plan.dims} (dimension-contiguous fallback)")
    lines = [
        f"[fleet] preset={plan.preset} ranks={plan.n_ranks} "
        f"replicas={plan.n_replicas} tp={plan.tp} "
        f"per_group={plan.per_group} {hier}",
    ]
    for strat in STRATEGIES:
        sc = plan.scores[strat]
        mark = " <== chosen" if strat == plan.chosen else ""
        lines.append(
            f"[fleet]   {strat:12s} global_B/tick={sc.global_bytes:12.0f} "
            f"local_B/tick={sc.local_bytes:12.0f} "
            f"tick={sc.tick_time_s * 1e6:9.1f}us{mark}")
    for i, nodes in enumerate(plan.replica_nodes):
        lines.append(f"[fleet]   replica {i}: nodes {list(nodes)}")
    return "\n".join(lines)
