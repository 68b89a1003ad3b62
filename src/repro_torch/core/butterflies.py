"""Butterfly pairings: Bine (paper Sec. 3.1, Eq. 4) and classical baselines.

A *butterfly* on p = 2**s ranks is s steps; at step i every rank exchanges
with exactly one partner (an involution with no fixed points).  The key
correctness property is the *cone* (butterfly-group) structure: define

    cone(r, s) = {r}
    cone(r, i) = cone(r, i+1) ∪ cone(partner_i(r), i+1)

Then a pairing is a valid butterfly iff cone(r, 0) = all ranks for every r,
which requires the level-i cones to form a partition into 2**i groups of
size 2**(s-i), with step-i partners drawn from the same level-i cone.

Bine butterflies additionally shrink the *modulo distance* of each exchange
to ~2/3 of the classical power-of-two distance (Eq. 2).

The PyTorch port's own copy of ``repro.core.butterflies``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, List

import numpy as np

from .negabinary import bine_delta, log2_int

PartnerFn = Callable[[int, int, int], int]  # (rank, p, step) -> partner


# ---------------------------------------------------------------------------
# Pairings
# ---------------------------------------------------------------------------

def bine_dh_partner(r: int, p: int, i: int) -> int:
    """Distance-halving Bine butterfly partner (Eq. 4).

    Even ranks move +delta, odd ranks -delta, delta = (1-(-2)^{s-i})/3.
    Distances shrink (±1 of halving) as i grows.
    """
    s = log2_int(p)
    d = bine_delta(s - i)
    return (r + d) % p if r % 2 == 0 else (r - d) % p


def bine_dd_partner(r: int, p: int, i: int) -> int:
    """Distance-doubling Bine butterfly: the halving one with steps reversed."""
    s = log2_int(p)
    return bine_dh_partner(r, p, s - 1 - i)


def recdoub_dh_partner(r: int, p: int, i: int) -> int:
    """Classical recursive-doubling butterfly, distance-halving order."""
    s = log2_int(p)
    return r ^ (1 << (s - 1 - i))


def recdoub_dd_partner(r: int, p: int, i: int) -> int:
    """Classical recursive-doubling butterfly, distance-doubling order."""
    return r ^ (1 << i)


BUTTERFLIES: dict[str, PartnerFn] = {
    "bine_dh": bine_dh_partner,
    "bine_dd": bine_dd_partner,
    "recdoub_dh": recdoub_dh_partner,
    "recdoub_dd": recdoub_dd_partner,
}


# ---------------------------------------------------------------------------
# Cone machinery (block bookkeeping for RS / AG / alltoall)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def partner_table(kind: str, p: int) -> np.ndarray:
    """[s, p] partner ids; validates the involution property."""
    s = log2_int(p)
    fn = BUTTERFLIES[kind]
    tab = np.empty((s, p), dtype=np.int64)
    for i in range(s):
        for r in range(p):
            q = fn(r, p, i)
            tab[i, r] = q
    for i in range(s):
        row = tab[i]
        assert (row[row] == np.arange(p)).all(), (kind, p, i, "not an involution")
        assert (row != np.arange(p)).all(), (kind, p, i, "fixed point")
    return tab


#: kinds whose *future* cones form a partition at every level — the
#: requirement for vector-halving reduce-scatter and alltoall routing.
#: The distance-halving Bine butterfly deliberately lacks it (its *forward*
#: accumulation groups are hierarchical instead, which is what allgather
#: needs) — this is why the paper pairs DD with RS and DH with AG (Sec. 4.3).
CONE_KINDS = ("bine_dd", "recdoub_dd", "recdoub_dh")


@lru_cache(maxsize=None)
def cones(kind: str, p: int) -> List[List[frozenset]]:
    """cone[i][r]: the set of ranks reachable from r using steps i..s-1.

    cone[s][r] = {r}; cone[i][r] = cone[i+1][r] | cone[i+1][partner_i(r)].
    Validates the partition property at every level.
    """
    if kind not in CONE_KINDS:
        raise ValueError(
            f"butterfly kind {kind!r} has no future-cone partition; "
            f"vector-halving collectives require one of {CONE_KINDS}")
    s = log2_int(p)
    tab = partner_table(kind, p)
    level: List[frozenset] = [frozenset([r]) for r in range(p)]
    out = [level]
    for i in range(s - 1, -1, -1):
        nxt = [level[r] | level[int(tab[i, r])] for r in range(p)]
        # Partition check: each rank's cone must contain exactly the ranks
        # sharing the same (interned) cone object.
        interned: dict = {}
        for r in range(p):
            assert len(nxt[r]) == 1 << (s - i), (kind, p, i, r, "cone size")
            key = min(nxt[r])
            if key in interned:
                assert interned[key] is nxt[r] or interned[key] == nxt[r], (
                    kind, p, i, "cones not shared")
                nxt[r] = interned[key]
            else:
                interned[key] = nxt[r]
        # every member of a cone must carry that same cone
        for key, cone_set in interned.items():
            for q in cone_set:
                assert nxt[q] is cone_set, (kind, p, i, "cones not shared")
        level = nxt
        out.append(level)
    out.reverse()  # out[i] = level-i cones, out[s] = singletons
    assert out[0][0] == frozenset(range(p))
    return out


@lru_cache(maxsize=None)
def half_choice(kind: str, p: int) -> np.ndarray:
    """c[i, r] ∈ {0,1}: which half of its level-i cone rank r's sub-cone is.

    Labelings follow each construction's natural bits so the induced final
    layout matches the literature exactly:
      * bine_dd    → bit i of v(r)   ⇒ final_block = reverse(v(r)),
                     the paper's Sec. 4.3.1 contiguity permutation;
      * recdoub_dd → bit i of r      ⇒ textbook bit-reversal layout;
      * recdoub_dh → bit s-1-i of r  ⇒ identity layout.
    Validated: partners at step i get opposite bits, and the bit is constant
    within each level-(i+1) cone (the two requirements for vector-halving).
    Used by reduce-scatter (keep half c, send half 1-c) and allgather
    (concatenation order).
    """
    s = log2_int(p)
    cs = cones(kind, p)
    c = np.zeros((s, p), dtype=np.int64)
    if kind == "bine_dd":
        from .negabinary import v_table
        lab = v_table(p)
        bit = lambda i: (lab >> i) & 1
    elif kind == "recdoub_dd":
        lab = np.arange(p)
        bit = lambda i: (lab >> i) & 1
    elif kind == "recdoub_dh":
        lab = np.arange(p)
        bit = lambda i: (lab >> (s - 1 - i)) & 1
    else:  # pragma: no cover
        raise ValueError(kind)
    for i in range(s):
        c[i] = bit(i)
    tab = partner_table(kind, p)
    for i in range(s):
        assert (c[i, tab[i]] == 1 - c[i]).all(), (kind, p, i, "halves clash")
        # constant within each level-(i+1) cone
        for r in range(p):
            assert all(c[i, q] == c[i, r] for q in cs[i + 1][r]), (
                kind, p, i, r, "half bit not cone-constant")
    return c


@lru_cache(maxsize=None)
def final_block(kind: str, p: int) -> np.ndarray:
    """b[r]: index of the vector block rank r holds after a vector-halving
    reduce-scatter run *without* any input permutation.

    b(r) = Σ_i c[i, r] · 2^{s-1-i}: the path of half-choices down the cone
    tree.  Its inverse is exactly the paper's Sec. 4.3.1 contiguity
    permutation (for bine_dd it coincides with reverse(v(r)) up to the
    canonical labeling).
    """
    s = log2_int(p)
    c = half_choice(kind, p)
    b = np.zeros(p, dtype=np.int64)
    for i in range(s):
        b += c[i] << (s - 1 - i)
    assert sorted(b.tolist()) == list(range(p)), (kind, p, "not a permutation")
    return b


@lru_cache(maxsize=None)
def rs_offsets(kind: str, p: int) -> np.ndarray:
    """off[i, r]: block offset of rank r's *kept* half at RS step i.

    At step i the working range has length p/2**i blocks and starts at
    Σ_{j<i} c[j,r] · p/2**(j+1); the kept half adds c[i,r] · p/2**(i+1).
    The *sent* half starts at the same base plus (1-c[i,r]) · p/2**(i+1).
    """
    s = log2_int(p)
    c = half_choice(kind, p)
    off = np.zeros((s, p), dtype=np.int64)
    base = np.zeros(p, dtype=np.int64)
    for i in range(s):
        off[i] = base + c[i] * (p >> (i + 1))
        base = off[i]
    return off


def modulo_distance_stats(kind: str, p: int) -> np.ndarray:
    """[s] mean modulo distance of exchanges per step (for Eq. 2 checks)."""
    tab = partner_table(kind, p)
    r = np.arange(p)
    a = (r[None, :] - tab) % p
    d = np.minimum(a, p - a)
    return d.mean(axis=1)
