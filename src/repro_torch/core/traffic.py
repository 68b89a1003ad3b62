"""Global-link traffic accounting and α-β performance model (paper Sec. 2.4, 5).

Counts, for any schedule from ``core.schedules``, the bytes crossing group
boundaries on grouped topologies (Dragonfly / Dragonfly+ / oversubscribed
fat-tree / TPU multi-pod) and hop-bytes on tori, plus a contention-aware
α-β time model used to reproduce the paper's win/loss tables and heatmaps.

All byte counts assume minimal inter-group routing, as the paper does
("the reductions we report should be interpreted as lower bounds").

The PyTorch port's own copy of ``repro.core.traffic``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .schedules import Msg, Sched, get_schedule


# ---------------------------------------------------------------------------
# Topologies
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GroupedTopo:
    """Two-tier network: fully-connected (fast) groups + sparse global links.

    Covers Dragonfly (LUMI), Dragonfly+ (Leonardo), 2:1-oversubscribed
    fat-tree subtrees (MareNostrum 5) and TPU multi-pod (ICI pods + DCN).
    """
    name: str
    group_size: int                  # nodes per group
    alpha_local: float = 1.0e-6      # s
    beta_local: float = 1.0 / 25e9   # s/B  (~200 Gb/s NIC)
    alpha_global: float = 2.0e-6
    beta_global: float = 1.0 / 25e9
    uplinks_per_group: int = 32      # concurrent crossing flows share these
    node_size: int = 1               # ranks per node (the innermost tier)

    def group_of(self, node: int) -> int:
        return node // self.group_size


#: presets mirroring the paper's four systems + the TPU target.
#: ``node_size`` = GPUs/chips per node: LUMI 4x MI250X (8 GCDs),
#: Leonardo/MN5 4x A100/H100, one TPU host = 4 chips — the innermost
#: tier ``topology.tier_split`` derives hierarchies from.
LUMI = GroupedTopo("lumi_dragonfly", group_size=124, node_size=8)
LEONARDO = GroupedTopo("leonardo_dragonfly_plus", group_size=180, node_size=4)
MARENOSTRUM5 = GroupedTopo("mn5_fat_tree_2to1", group_size=160,
                           uplinks_per_group=80, node_size=4)
TPU_MULTIPOD = GroupedTopo(
    "tpu_multipod", group_size=256,
    alpha_local=1.0e-6, beta_local=1.0 / 50e9,     # ICI per-link
    alpha_global=10.0e-6, beta_global=1.0 / 25e9,  # DCN per pod-pair
    uplinks_per_group=8, node_size=4,
)


@dataclass(frozen=True)
class TorusTopo:
    """d-dimensional torus (Fugaku-like).  Cost ∝ hop-bytes."""
    name: str
    dims: Tuple[int, ...]
    alpha: float = 1.0e-6
    beta: float = 1.0 / 6.8e9  # 54.4 Gb/s TNI

    def coords(self, node: int) -> Tuple[int, ...]:
        c = []
        for d in reversed(self.dims):
            c.append(node % d)
            node //= d
        return tuple(reversed(c))

    def hops(self, a: int, b: int) -> int:
        ca, cb = self.coords(a), self.coords(b)
        h = 0
        for x, y, d in zip(ca, cb, self.dims):
            delta = abs(x - y)
            h += min(delta, d - delta)
        return h


# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------

def msg_bytes(m: Msg, p: int, vec_bytes: float) -> float:
    return m.nblocks(p) * vec_bytes / p


def total_bytes(sched: Sched, p: int, vec_bytes: float) -> float:
    return sum(msg_bytes(m, p, vec_bytes) for step in sched for m in step)


def global_bytes(
    sched: Sched,
    p: int,
    vec_bytes: float,
    topo: GroupedTopo,
    placement: Optional[Sequence[int]] = None,
) -> float:
    """Bytes crossing group boundaries.  ``placement[r]`` = node of rank r
    (defaults to the identity: rank == node, linear block placement)."""
    place = (lambda r: r) if placement is None else (lambda r: placement[r])
    out = 0.0
    for step in sched:
        for m in step:
            if topo.group_of(place(m.src)) != topo.group_of(place(m.dst)):
                out += msg_bytes(m, p, vec_bytes)
    return out


def hop_bytes(
    sched: Sched,
    p: int,
    vec_bytes: float,
    topo: TorusTopo,
    placement: Optional[Sequence[int]] = None,
) -> float:
    """Σ bytes·hops over all messages (torus link-load proxy)."""
    place = (lambda r: r) if placement is None else (lambda r: placement[r])
    out = 0.0
    for step in sched:
        for m in step:
            out += msg_bytes(m, p, vec_bytes) * topo.hops(place(m.src), place(m.dst))
    return out


def traffic_reduction(
    collective: str,
    algo_bine: str,
    algo_base: str,
    p: int,
    vec_bytes: float,
    topo: GroupedTopo,
    placement: Optional[Sequence[int]] = None,
    root: int = 0,
) -> float:
    """(base_global - bine_global) / base_global, as in Tables 3-5."""
    gb = global_bytes(get_schedule(collective, algo_bine, p, root), p, vec_bytes,
                      topo, placement)
    ga = global_bytes(get_schedule(collective, algo_base, p, root), p, vec_bytes,
                      topo, placement)
    if ga == 0:
        return 0.0
    return (ga - gb) / ga


# ---------------------------------------------------------------------------
# Closed-form byte counts for composed (hierarchical) schedules
# ---------------------------------------------------------------------------

def _tier_wire_blocks(collective: str, algo: str, pt: int) -> int:
    """Σ blocks on the wire across the flat tier schedule at radix ``pt``
    (the same builder ``compose`` lifts, adapters included)."""
    sched = get_schedule(collective, algo, pt)
    return sum(m.nblocks(pt) for step in sched for m in step)


def compose_phase_bytes(
    collective: str,
    tiers: Sequence[int],
    vec_bytes: float,
    algo: str = "bine",
) -> Tuple[float, ...]:
    """Per-phase wire bytes of ``compose(collective, tiers, algo)``,
    indexed by tier (innermost first, i.e. digit order — not execution
    order; allgather runs the same phases mirrored, allreduce both ways).

    Phase j runs the flat radix-``tiers[j]`` schedule inside each of the
    p/tiers[j] subgroups, and every virtual block lifts to
    ``E_j = prod(tiers[j+1:])`` real blocks of ``vec_bytes / p``, so

        bytes_j = (p / p_j) · wire_blocks(p_j) · E_j · vec_bytes / p.

    Exact for any tier radix: non-pow2 tiers are priced through the same
    fold / 3-2-elimination adapters ``compose`` lifts.
    """
    tiers = tuple(int(t) for t in tiers)
    p = int(np.prod(tiers))
    out = []
    for j, pt in enumerate(tiers):
        if pt == 1:
            out.append(0.0)
            continue
        e_j = int(np.prod(tiers[j + 1:], dtype=np.int64))
        if collective == "allreduce":
            wire = (_tier_wire_blocks("reduce_scatter", algo, pt)
                    + _tier_wire_blocks("allgather", algo, pt))
        else:
            wire = _tier_wire_blocks(collective, algo, pt)
        out.append((p // pt) * wire * e_j * vec_bytes / p)
    return tuple(out)


def compose_global_bytes(
    collective: str,
    tiers: Sequence[int],
    vec_bytes: float,
    per_group: int,
    algo: str = "bine",
) -> float:
    """Bytes of ``compose(collective, tiers, algo)`` crossing group
    boundaries under tier-aligned placement (``per_group`` consecutive
    ranks per group, as the reference's ``tuner.trace.spread_placement``
    builds it).

    ``per_group`` must equal ``prod(tiers[:k])`` for some k.  Then phase
    j < k stays inside one group (its subgroup spans prod(tiers[:j+1])
    ≤ per_group consecutive ranks starting at a multiple of it) and
    phase j ≥ k is entirely crossing (peers differ by a nonzero multiple
    of the digit stride, itself a multiple of per_group), so the global
    traffic is exactly the sum of the outer phases — this is the closed
    form behind the hierarchy's locality win: the inner (p_0−1)·E_0 term,
    the bulk of the bytes, never leaves the group.
    """
    tiers = tuple(int(t) for t in tiers)
    prefix, k = 1, None
    for i in range(len(tiers) + 1):
        if prefix == per_group:
            k = i
            break
        if i < len(tiers):
            prefix *= tiers[i]
    if k is None:
        raise ValueError(
            f"per_group={per_group} is not a prefix product of tiers "
            f"{tiers}; tier-aligned placement needs prod(tiers[:k])")
    return float(sum(
        compose_phase_bytes(collective, tiers, vec_bytes, algo)[k:]))


# ---------------------------------------------------------------------------
# α-β time model with global-link contention
# ---------------------------------------------------------------------------

def sched_time(
    sched: Sched,
    p: int,
    vec_bytes: float,
    topo: GroupedTopo,
    placement: Optional[Sequence[int]] = None,
    segment_bytes: Optional[float] = None,
) -> float:
    """Bulk-synchronous estimate: per step, every flow proceeds in parallel;
    flows crossing a group's uplinks share them; the step ends when the
    slowest flow ends.  ``segment_bytes`` models pipelined segmentation by
    amortizing α over ceil(msg/segment) chunks (paper Sec. 5.2.2).
    """
    place = (lambda r: r) if placement is None else (lambda r: placement[r])
    t = 0.0
    for step in sched:
        crossing: Dict[int, int] = {}
        flows: List[Tuple[float, bool, int]] = []
        for m in step:
            gs, gd = topo.group_of(place(m.src)), topo.group_of(place(m.dst))
            b = msg_bytes(m, p, vec_bytes)
            cross = gs != gd
            if cross:
                crossing[gs] = crossing.get(gs, 0) + 1
            flows.append((b, cross, gs))
        worst = 0.0
        for b, cross, gs in flows:
            if cross:
                share = max(1.0, crossing[gs] / topo.uplinks_per_group)
                tm = topo.alpha_global + b * topo.beta_global * share
            else:
                tm = topo.alpha_local + b * topo.beta_local
            worst = max(worst, tm)
        t += worst
    return t


def torus_time(
    sched: Sched,
    p: int,
    vec_bytes: float,
    topo: TorusTopo,
    placement: Optional[Sequence[int]] = None,
) -> float:
    """Per step: slowest flow, charged α·hops + bytes·β·mean-link-contention."""
    place = (lambda r: r) if placement is None else (lambda r: placement[r])
    n_links = len(topo.dims) * 2 * int(np.prod(topo.dims))
    t = 0.0
    for step in sched:
        hb = 0.0
        worst = 0.0
        msgs = []
        for m in step:
            h = topo.hops(place(m.src), place(m.dst))
            b = msg_bytes(m, p, vec_bytes)
            hb += h * b
            msgs.append((h, b))
        mean_load = hb / max(n_links, 1)
        for h, b in msgs:
            contention = max(1.0, hb / (b * max(h, 1)) / max(n_links, 1) * len(msgs))
            worst = max(worst, topo.alpha * max(h, 1) + b * topo.beta
                        + mean_load * topo.beta)
        t += worst
    return t


# ---------------------------------------------------------------------------
# Allocation sampling (Fig. 5 reproduction)
# ---------------------------------------------------------------------------

def sample_allocation(
    rng: np.random.RandomState,
    n_nodes: int,
    topo: GroupedTopo,
    n_groups_total: int = 24,
) -> List[int]:
    """Sample a scheduler-like allocation: nodes spread over a random subset
    of groups with uneven per-group counts, then sorted (the paper's
    'sort ranks by hostname' block remapping).  Returns node ids per rank.
    """
    g = topo.group_size
    max_groups = min(n_groups_total, max(1, int(np.ceil(n_nodes / g))))
    # jobs usually spread across more groups than strictly needed
    spread = rng.randint(max_groups, min(n_groups_total, max_groups * 4) + 1)
    groups = rng.choice(n_groups_total, size=spread, replace=False)
    # uneven distribution of node counts over the chosen groups
    weights = rng.dirichlet(np.ones(spread) * 1.5)
    counts = np.maximum(0, np.round(weights * n_nodes).astype(int))
    counts = np.minimum(counts, g)
    # fix rounding to hit exactly n_nodes
    while counts.sum() < n_nodes:
        i = rng.randint(spread)
        if counts[i] < g:
            counts[i] += 1
    while counts.sum() > n_nodes:
        i = rng.randint(spread)
        if counts[i] > 0:
            counts[i] -= 1
    nodes: List[int] = []
    for grp, cnt in zip(groups, counts):
        slots = rng.choice(g, size=cnt, replace=False)
        nodes.extend(int(grp) * g + int(s) for s in slots)
    nodes.sort()
    return nodes


def allocation_reduction_distribution(
    collective: str,
    algo_bine: str,
    algo_base: str,
    n_nodes: int,
    topo: GroupedTopo,
    n_jobs: int = 50,
    vec_bytes: float = 1 << 20,
    seed: int = 0,
) -> np.ndarray:
    """Traffic-reduction distribution across sampled allocations (Fig. 5)."""
    rng = np.random.RandomState(seed)
    sb = get_schedule(collective, algo_bine, n_nodes)
    sa = get_schedule(collective, algo_base, n_nodes)
    out = []
    for _ in range(n_jobs):
        placement = sample_allocation(rng, n_nodes, topo)
        gb = global_bytes(sb, n_nodes, vec_bytes, topo, placement)
        ga = global_bytes(sa, n_nodes, vec_bytes, topo, placement)
        out.append(0.0 if ga == 0 else (ga - gb) / ga)
    return np.array(out)
