"""Static butterfly tables for the stacked-rank collectives.

The port's copy of the butterfly part of ``repro.core.tables``.  Plain
numpy: the stacked executor turns each step's ``perms`` into an index
gather over the rank dimension and each ``cbit`` row into an int32 ``[p]``
tensor on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np

from . import butterflies as bf
from .negabinary import log2_int


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
