"""Static lookup tables baked into the stacked-rank collectives.

The port's own copy of ``repro.core.tables``.  Plain numpy, derived from
the verified schedules in ``core.schedules``: the stacked executor turns
each step's ``perms`` into an index gather over the rank dimension and
each per-rank table row (``cbit[i]``, ``recv_step``, ``recv_off[j]``,
``send_slots[j]``, ...) into an int32 tensor on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from . import butterflies as bf
from . import schedules as sc
from .negabinary import log2_int, reverse_bits, v_table


# ---------------------------------------------------------------------------
# Butterfly tables (reduce-scatter / allgather / allreduce-large / small)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ButterflyTables:
    """All static data for a vector-halving/-doubling butterfly on p ranks.

    Offsets are in *block* units (block = vec/p).
    """
    p: int
    s: int
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]  # [s] (src, dst) pair lists
    keep_off: np.ndarray    # [s, p] kept-half block offset at RS step i
    send_off: np.ndarray    # [s, p] sent-half block offset at RS step i
    cbit: np.ndarray        # [s, p] half-choice bit (0 = lower half kept)
    final_block: np.ndarray  # [p] position-block held after RS (= reverse(v))
    inv_final: np.ndarray   # [p] inverse permutation


@lru_cache(maxsize=None)
def butterfly_tables(kind: str, p: int) -> ButterflyTables:
    s = log2_int(p)
    tab = bf.partner_table(kind, p)
    c = bf.half_choice(kind, p)
    keep = bf.rs_offsets(kind, p)
    half = np.array([p >> (i + 1) for i in range(s)])[:, None]
    send = keep + (1 - 2 * c) * half
    fb = bf.final_block(kind, p)
    inv = np.argsort(fb)
    perms = tuple(
        tuple((r, int(tab[i, r])) for r in range(p)) for i in range(s)
    )
    return ButterflyTables(p, s, perms, keep, send, c, fb, inv)


@lru_cache(maxsize=None)
def small_butterfly_perms(kind: str, p: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Pair lists for full-vector recursive-doubling exchange (allreduce small)."""
    s = log2_int(p)
    tab = bf.partner_table(kind, p)
    return tuple(tuple((r, int(tab[i, r])) for r in range(p)) for i in range(s))


# ---------------------------------------------------------------------------
# Tree tables (broadcast / reduce, small vectors)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TreeTables:
    p: int
    s: int
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]  # bcast direction per step
    recv_step: np.ndarray  # [p] step at which rank receives (-1 for root)


@lru_cache(maxsize=None)
def tree_tables(algo: str, p: int, root: int = 0) -> TreeTables:
    from . import trees as tr
    sched = tr.rotate_schedule(tr.TREES[algo](p), root, p)
    s = len(sched)
    recv_step = np.full(p, -1, dtype=np.int64)
    perms = []
    for i, step in enumerate(sched):
        perms.append(tuple(step))
        for _, dst in step:
            assert recv_step[dst] == -1
            recv_step[dst] = i
    assert (recv_step >= 0).sum() == p - 1
    return TreeTables(p, s, tuple(perms), recv_step)


# ---------------------------------------------------------------------------
# Gather / Scatter window tables
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GatherTables:
    """Local-window bookkeeping for tree gather/scatter.

    Each rank owns a p-block local buffer; local position t of rank r holds
    the block at *position-space* index (anchor[r] + t) mod p, where
    position space is block space mapped through ``posmap`` (identity for
    distance-halving trees; reverse(v(·)) for distance-doubling trees,
    the paper's Sec. 4.3.1 contiguity permutation).
    """
    p: int
    s: int
    posmap: np.ndarray        # [p] block -> position
    anchor: np.ndarray        # [p] per-rank window anchor (position space)
    own_local: np.ndarray     # [p] local offset of rank's own block
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]   # gather direction
    sizes: Tuple[int, ...]    # [s] blocks moved per message at step j
    recv_off: np.ndarray      # [s, p] local offset where receiver places data
    recv_mask: np.ndarray     # [s, p] bool: rank receives at step j
    send_mask: np.ndarray     # [s, p] bool: rank sends at step j
    root_unrot: np.ndarray    # [p] out[k] = local[root_unrot[k]] at the root


@lru_cache(maxsize=None)
def gather_tables(algo: str, p: int, root: int = 0) -> GatherTables:
    """Derived by replaying the verified gather schedule in position space.

    Non-zero roots reuse the root-0 replay with the paper's logical rotation
    (position space is abstract, so only rank/block indexing rotates).
    """
    if root % p != 0:
        t0 = gather_tables(algo, p, 0)
        rot = (np.arange(p) - root) % p
        return GatherTables(
            p, t0.s,
            posmap=t0.posmap[rot],
            anchor=t0.anchor[rot],
            own_local=t0.own_local[rot],
            perms=tuple(tuple(((a + root) % p, (b + root) % p) for a, b in st)
                        for st in t0.perms),
            sizes=t0.sizes,
            recv_off=t0.recv_off[:, rot],
            recv_mask=t0.recv_mask[:, rot],
            send_mask=t0.send_mask[:, rot],
            root_unrot=t0.root_unrot[rot],
        )
    s = log2_int(p)
    sched = sc.gather_sched(algo, p, 0)
    if algo in ("bine_dd",):
        posmap = np.array([reverse_bits(int(v), s) for v in v_table(p)])
    else:
        posmap = np.arange(p)
    # replay: windows in position space, tracked as (start, length) mod p
    win: List[Tuple[int, int]] = [(int(posmap[r]), 1) for r in range(p)]
    send_anchor = np.full(p, -1, dtype=np.int64)
    sizes: List[int] = []
    perms: List[Tuple[Tuple[int, int], ...]] = []
    recv_off = np.zeros((len(sched), p), dtype=np.int64)
    recv_mask = np.zeros((len(sched), p), dtype=bool)
    send_mask = np.zeros((len(sched), p), dtype=bool)
    for j, step in enumerate(sched):
        size = None
        pairs = []
        for m in step:
            src, dst = m.src, m.dst
            pos = [int(posmap[b]) for b in m.blocks]
            st, ln = win[src]
            # sent blocks must be exactly the sender's contiguous window
            assert ln == len(pos), (algo, p, j, src)
            assert sorted((q - st) % p for q in pos) == list(range(ln)), (
                algo, p, j, src, "window not contiguous in position space")
            size = ln if size is None else size
            assert size == ln, "non-uniform message size within a step"
            send_anchor[src] = st
            pairs.append((src, dst))
            # merge into receiver window
            dst_st, dst_ln = win[dst]
            if (dst_st + dst_ln) % p == st:          # extend upward
                win[dst] = (dst_st, dst_ln + ln)
            elif (st + ln) % p == dst_st:            # extend downward
                win[dst] = (st, dst_ln + ln)
            else:
                raise AssertionError((algo, p, j, "windows not adjacent"))
            recv_mask[j, dst] = True
            send_mask[j, src] = True
        sizes.append(size)
        perms.append(tuple(pairs))
    # anchors: send-time window start; root (never sends): final window start
    anchor = send_anchor.copy()
    anchor[root] = win[root][0]
    assert win[root][1] == p
    # incoming placement offsets relative to the receiver's anchor
    win2: List[Tuple[int, int]] = [(int(posmap[r]), 1) for r in range(p)]
    for j, step in enumerate(sched):
        for m in step:
            src, dst = m.src, m.dst
            st, ln = win2[src]
            recv_off[j, dst] = (st - anchor[dst]) % p
            assert recv_off[j, dst] + ln <= p
            dst_st, dst_ln = win2[dst]
            if (dst_st + dst_ln) % p == st:
                win2[dst] = (dst_st, dst_ln + ln)
            else:
                win2[dst] = (st, dst_ln + ln)
    own_local = np.array([(int(posmap[r]) - anchor[r]) % p for r in range(p)])
    root_unrot = np.array([(int(posmap[b]) - anchor[root]) % p for b in range(p)])
    return GatherTables(
        p, len(sched), posmap, anchor, own_local, tuple(perms), tuple(sizes),
        recv_off, recv_mask, send_mask, root_unrot)


@dataclass(frozen=True)
class ScatterTables:
    p: int
    s: int
    posmap: np.ndarray
    root_rot: np.ndarray      # [p] pre-rotation at root: local[t] = x[root_rot[t]]
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]
    sizes: Tuple[int, ...]
    send_off: np.ndarray      # [s, p] local offset of the outgoing window
    recv_mask: np.ndarray
    send_mask: np.ndarray
    own_local: np.ndarray     # [p] where the own block lands locally


@lru_cache(maxsize=None)
def scatter_tables(algo: str, p: int, root: int = 0) -> ScatterTables:
    """Scatter = reversed gather; every rank receives its subtree window once
    (placed at local offset 0 — anchor = subtree window start), then carves
    halves off it."""
    if root % p != 0:
        t0 = scatter_tables(algo, p, 0)
        rot = (np.arange(p) - root) % p
        return ScatterTables(
            p, t0.s,
            posmap=t0.posmap[rot],
            root_rot=(t0.root_rot + root) % p,
            perms=tuple(tuple(((a + root) % p, (b + root) % p) for a, b in st)
                        for st in t0.perms),
            sizes=t0.sizes,
            send_off=t0.send_off[:, rot],
            recv_mask=t0.recv_mask[:, rot],
            send_mask=t0.send_mask[:, rot],
            own_local=t0.own_local[rot],
        )
    s = log2_int(p)
    sched = sc.scatter_sched(algo, p, 0)
    if algo in ("bine_dd",):
        posmap = np.array([reverse_bits(int(v), s) for v in v_table(p)])
    else:
        posmap = np.arange(p)
    # window at receive time = rank's full subtree
    win: Dict[int, Tuple[int, int]] = {}
    sizes: List[int] = []
    perms: List[Tuple[Tuple[int, int], ...]] = []
    nsteps = len(sched)
    send_off = np.zeros((nsteps, p), dtype=np.int64)
    recv_mask = np.zeros((nsteps, p), dtype=bool)
    send_mask = np.zeros((nsteps, p), dtype=bool)
    anchor = np.full(p, -1, dtype=np.int64)

    # root's initial window: all p blocks; anchor chosen so that every block
    # is reachable without wrap: use the root's gather anchor (same window).
    g = gather_tables(algo, p, root)
    anchor[root] = g.anchor[root]
    win[root] = (int(anchor[root]), p)

    for j, step in enumerate(sched):
        size = None
        pairs = []
        for m in step:
            src, dst = m.src, m.dst
            pos = sorted(int(posmap[b]) for b in m.blocks)
            ln = len(pos)
            size = ln if size is None else size
            assert size == ln
            st0, l0 = win[src]
            offs = sorted((q - st0) % p for q in pos)
            assert offs == list(range(offs[0], offs[0] + ln)), (
                algo, p, j, "scatter send not contiguous")
            lo_pos = (st0 + offs[0]) % p
            send_off[j, src] = (lo_pos - anchor[src]) % p
            # sender keeps the other part of its window
            if offs[0] == 0:
                win[src] = ((st0 + ln) % p, l0 - ln)
            else:
                assert offs[0] + ln == l0, "sent chunk not at window edge"
                win[src] = (st0, l0 - ln)
            anchor[dst] = lo_pos
            win[dst] = (lo_pos, ln)
            recv_mask[j, dst] = True
            send_mask[j, src] = True
            pairs.append((src, dst))
        sizes.append(size)
        perms.append(tuple(pairs))
    own_local = np.array([(int(posmap[r]) - anchor[r]) % p for r in range(p)])
    root_rot = np.array([np.argmax(posmap == (anchor[root] + t) % p)
                         for t in range(p)], dtype=np.int64)
    return ScatterTables(
        p, nsteps, posmap, root_rot, tuple(perms), tuple(sizes), send_off,
        recv_mask, send_mask, own_local)


# ---------------------------------------------------------------------------
# Alltoall slot tables
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AlltoallTables:
    p: int
    s: int
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]
    send_slots: np.ndarray   # [s, p, p//2] local slot ids to send at step i
    recv_slots: np.ndarray   # [s, p, p//2] local slot ids receiving at step i
    final_slots: np.ndarray  # [p, p] out[origin o] = buf[final_slots[r, o]]
    send_contig: bool        # whether every send slot list is a contiguous run


@lru_cache(maxsize=None)
def alltoall_tables(algo: str, p: int) -> AlltoallTables:
    """Slot-level replay of the alltoall schedule.

    Local buffer slot d initially holds the block destined to rank d.
    Received chunks overwrite the slots just vacated by the send (send and
    recv sizes are both p/2 every step, so occupancy stays exact).
    """
    s = log2_int(p)
    if algo == "bruck":
        sched = sc.bruck_alltoall_sched(p)
    else:
        sched = sc.alltoall_sched(algo, p)
    # slot_content[r][t] = (dest, origin) key at local slot t of rank r
    slot: List[List[Tuple[int, int]]] = [
        [(d, r) for d in range(p)] for r in range(p)
    ]
    nsteps = len(sched)
    send_slots = np.zeros((nsteps, p, p // 2), dtype=np.int64)
    recv_slots = np.zeros((nsteps, p, p // 2), dtype=np.int64)
    perms = []
    contig = True
    for j, step in enumerate(sched):
        pairs = []
        incoming: Dict[int, List[Tuple[int, int]]] = {}
        vacated: Dict[int, List[int]] = {}
        for m in step:
            src, dst = m.src, m.dst
            keys = [(k // p, k % p) for k in m.blocks]
            idxs = [slot[src].index(k) for k in keys]
            assert len(idxs) == p // 2
            send_slots[j, src] = idxs
            if sorted(idxs) != list(range(min(idxs), min(idxs) + len(idxs))):
                contig = False
            incoming[dst] = keys
            vacated[src] = idxs
            pairs.append((src, dst))
        perms.append(tuple(pairs))
        for r in range(p):
            iv = vacated[r]
            ik = incoming[r]
            recv_slots[j, r] = iv
            for t, k in zip(iv, ik):
                slot[r][t] = k
    final_slots = np.zeros((p, p), dtype=np.int64)
    for r in range(p):
        for t, (d, o) in enumerate(slot[r]):
            assert d == r
            final_slots[r, o] = t
    return AlltoallTables(p, nsteps, tuple(perms), send_slots, recv_slots,
                          final_slots, contig)
