"""Negabinary rank arithmetic — the algebra behind Bine trees (paper Sec. 2.3.1, 3.2.1).

Every rank of a p-rank collective (p = 2**s) gets an s-bit *negabinary*
(base -2) label.  Ranks in ``[0, m]`` (right of the root on the rank circle)
use the negabinary representation of ``r``; ranks in ``(m, p)`` (left of the
root) use the representation of ``r - p``, where ``m`` is the largest
non-negative integer representable in s negabinary bits (``0101...01`` —
ones in the even positions).

All functions are plain-int and numpy-vectorized.  This is the PyTorch
port's own copy of ``repro.core.negabinary`` (the port imports nothing of
the JAX package); the stacked collectives bake its outputs in as static
index tables.
"""

from __future__ import annotations

import numpy as np

# A wide alternating 1010...10 mask.  Schroeppel's trick converts two's
# complement to negabinary: nb = (n + MASK) ^ MASK, and back:
# n = (nb ^ MASK) - MASK.  64 alternating bits cover any |n| < 2**62.
_MASK = 0xAAAAAAAAAAAAAAAA


def int_to_neg(n: int) -> int:
    """Negabinary bit pattern (as a python int) of integer ``n`` (may be <0)."""
    return (int(n) + _MASK) ^ _MASK


def neg_to_int(nb: int) -> int:
    """Signed integer value of negabinary bit pattern ``nb``."""
    return (int(nb) ^ _MASK) - _MASK


def log2_int(p: int) -> int:
    s = int(p).bit_length() - 1
    if (1 << s) != p:
        raise ValueError(f"p={p} is not a power of two")
    return s


def max_positive(s: int) -> int:
    """Largest value representable in ``s`` negabinary bits: 0101...01₋₂.

    Ones in even bit positions only (even powers of -2 are positive).
    E.g. s=6 → 010101₋₂ = 16+4+1 = 21;  s=3 → 101₋₂ = 5.
    """
    return neg_to_int(sum(1 << j for j in range(0, s, 2)))


def rank2nb(r: int, p: int) -> int:
    """Rank identifier → s-bit negabinary label (paper Sec. 2.3.1)."""
    s = log2_int(p)
    m = max_positive(s)
    r = int(r) % p
    nb = int_to_neg(r) if r <= m else int_to_neg(r - p)
    assert nb < (1 << s), (r, p, nb)
    return nb


def nb2rank(nb: int, p: int) -> int:
    """s-bit negabinary label → rank identifier in [0, p)."""
    return neg_to_int(nb) % p


def trailing_run(nb: int, s: int) -> int:
    """Length u of the run of equal bits starting at the LSB of an s-bit label.

    E.g. (paper Sec. 2.3.2, 16 ranks): u=3 for 1000, u=2 for 1011.
    """
    b0 = nb & 1
    u = 0
    for j in range(s):
        if (nb >> j) & 1 == b0:
            u += 1
        else:
            break
    return u


def ones(k: int) -> int:
    """k least-significant bits set: the XOR masks 1, 11, 111, ... of Eq. 1."""
    return (1 << k) - 1


# ---------------------------------------------------------------------------
# Distance-doubling labels (paper Sec. 3.2.1)
# ---------------------------------------------------------------------------

def h_label(r: int, p: int) -> int:
    """h(r,p): rank2nb(p-r) for even ranks, rank2nb(r) for odd ranks."""
    r = int(r) % p
    return rank2nb((p - r) % p, p) if r % 2 == 0 else rank2nb(r, p)


def v_label(r: int, p: int) -> int:
    """v(r,p) = h(r,p) XOR (h(r,p) >> 1) — the distance-doubling tree label."""
    h = h_label(r, p)
    return h ^ (h >> 1)


def v_table(p: int) -> np.ndarray:
    """v(r) for every rank, as an int64 array of length p."""
    return np.array([v_label(r, p) for r in range(p)], dtype=np.int64)


def v_inverse(p: int) -> np.ndarray:
    """inv[v] = r such that v_label(r) == v.  Raises if v is not a bijection."""
    vt = v_table(p)
    inv = np.full(p, -1, dtype=np.int64)
    inv[vt] = np.arange(p, dtype=np.int64)
    if (inv < 0).any():
        raise AssertionError(f"v labels are not a bijection for p={p}")
    return inv


def reverse_bits(x: int, s: int) -> int:
    out = 0
    for j in range(s):
        out |= ((x >> j) & 1) << (s - 1 - j)
    return out


# ---------------------------------------------------------------------------
# Modulo distance (paper Sec. 2.2) and butterfly deltas (Eq. 3/4)
# ---------------------------------------------------------------------------

def mod_distance(r: int, q: int, p: int) -> int:
    """d(r,q) = min((r-q) mod p, (q-r) mod p)."""
    a = (r - q) % p
    return min(a, p - a)


def bine_delta(k: int) -> int:
    """|Σ_{j<k} (-2)^j| signed form: (1 - (-2)**k) / 3  (Eq. 3 numerator).

    This is the value of the negabinary number 111...1 (k ones):
    k=1 → 1, k=2 → -1, k=3 → 3, k=4 → -5, k=5 → 11, ...
    """
    return (1 - (-2) ** k) // 3
