"""Tree constructions: Bine (paper Sec. 2-3) and classical binomial baselines.

A *tree schedule* for p ranks is a list of steps; step ``i`` is a list of
``(src, dst)`` pairs.  For a broadcast rooted at 0, every rank receives
exactly once, senders already hold the data, and after ``s = log2(p)``
steps all ranks hold it.  Reduce / gather / scatter reuse the same trees
with time reversed.

Every function takes the root as rank 0; roots ``t != 0`` are handled by the
callers with the paper's logical rotation (subtract ``t`` mod p).

The PyTorch port's own copy of ``repro.core.trees`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

from .negabinary import (
    log2_int,
    nb2rank,
    ones,
    rank2nb,
    trailing_run,
    v_inverse,
    v_table,
)

Step = List[Tuple[int, int]]
Schedule = List[Step]


# ---------------------------------------------------------------------------
# Bine distance-halving tree (paper Sec. 2.3)
# ---------------------------------------------------------------------------

def bine_dh_join_step(r: int, p: int) -> int:
    """Step at which rank r receives in a root-0 distance-halving Bine bcast.

    i = s - u, with u the trailing equal-bit run of rank2nb(r) (Sec. 2.3.2).
    The root never receives; we return -1 for it.
    """
    if r % p == 0:
        return -1
    s = log2_int(p)
    return s - trailing_run(rank2nb(r, p), s)


def bine_dh_peer(r: int, p: int, i: int) -> int:
    """Partner of rank r at step i (Eq. 1): XOR the s-i LSBs of the label."""
    s = log2_int(p)
    return nb2rank(rank2nb(r, p) ^ ones(s - i), p)


@lru_cache(maxsize=None)
def bine_dh_tree(p: int) -> Schedule:
    """Full (src, dst) schedule of the distance-halving Bine broadcast."""
    s = log2_int(p)
    sched: Schedule = []
    has = [r == 0 for r in range(p)]
    for i in range(s):
        step: Step = []
        nxt = list(has)
        for r in range(p):
            if has[r]:
                q = bine_dh_peer(r, p, i)
                step.append((r, q))
                nxt[q] = True
        has = nxt
        sched.append(step)
    assert all(has), f"bine_dh_tree does not cover all ranks for p={p}"
    return sched


# ---------------------------------------------------------------------------
# Bine distance-doubling tree (paper Sec. 3.2)
# ---------------------------------------------------------------------------

def bine_dd_join_step(r: int, p: int) -> int:
    """Rank r receives at the position of the MSB set in v(r) (Sec. 3.2.2)."""
    if r % p == 0:
        return -1
    v = int(v_table(p)[r % p])
    return v.bit_length() - 1


@lru_cache(maxsize=None)
def bine_dd_tree(p: int) -> Schedule:
    """Distance-doubling Bine broadcast: binomial algorithm in v-space.

    At step i, every rank whose v-label has all bits >= i clear sends to the
    rank whose v-label differs in bit i.
    """
    s = log2_int(p)
    vt = v_table(p)
    inv = v_inverse(p)
    sched: Schedule = []
    for i in range(s):
        step: Step = []
        for r in range(p):
            if vt[r] < (1 << i):  # r already has the data (msb(v) < i or root)
                q = int(inv[vt[r] ^ (1 << i)])
                step.append((r, q))
        sched.append(step)
    return sched


# ---------------------------------------------------------------------------
# Classical binomial trees (baselines; Open MPI / MPICH constructions)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def binomial_dd_tree(p: int) -> Schedule:
    """Distance-doubling binomial bcast (Open MPI style, Fig. 1 top).

    Step i: ranks r < 2**i send to r + 2**i.
    """
    s = log2_int(p)
    return [
        [(r, r + (1 << i)) for r in range(min(1 << i, p - (1 << i)))]
        for i in range(s)
    ]


@lru_cache(maxsize=None)
def binomial_dh_tree(p: int) -> Schedule:
    """Distance-halving binomial bcast (MPICH style, Fig. 1 bottom).

    Step i: ranks r with the s-i low bits zero send to r + 2**(s-i-1).
    """
    s = log2_int(p)
    sched: Schedule = []
    for i in range(s):
        d = 1 << (s - i - 1)
        step = [(r, r + d) for r in range(0, p, 2 * d)]
        sched.append(step)
    return sched


TREES = {
    "bine_dh": bine_dh_tree,
    "bine_dd": bine_dd_tree,
    "binomial_dh": binomial_dh_tree,
    "binomial_dd": binomial_dd_tree,
}


def rotate_schedule(sched: Schedule, root: int, p: int) -> Schedule:
    """Re-root a root-0 schedule at ``root`` by rotating rank ids (Sec. 2.2)."""
    if root % p == 0:
        return sched
    return [[((a + root) % p, (b + root) % p) for a, b in step] for step in sched]


def subtree_blocks(sched: Schedule, p: int) -> List[List[int]]:
    """For each rank, the ranks in the subtree it roots (itself + descendants).

    Computed by replaying the schedule backwards: a node's subtree is itself
    plus the subtrees of every rank it sends to after joining.
    """
    children: List[List[int]] = [[] for _ in range(p)]
    for step in sched:
        for src, dst in step:
            children[src].append(dst)

    out: List[List[int]] = [[] for _ in range(p)]

    def collect(r: int) -> List[int]:
        if not out[r]:
            acc = [r]
            for c in children[r]:
                acc.extend(collect(c))
            out[r] = acc
        return out[r]

    for r in range(p):
        collect(r)
    return out
