"""Named topology presets the auto-selector builds decision tables for.

The grouped presets are the paper's four measured systems plus the TPU
multi-pod target (all defined in ``core.traffic``); ``torus`` is the
Fugaku-like d-dimensional torus, materialized per rank count because hop
distances depend on the torus dimensions.

The PyTorch port's own copy of ``repro.topology.presets``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

from repro_torch.core.traffic import (LEONARDO, LUMI, MARENOSTRUM5,
                                      TPU_MULTIPOD, GroupedTopo, TorusTopo)

GROUPED_PRESETS = {
    "lumi": LUMI,
    "leonardo": LEONARDO,
    "marenostrum5": MARENOSTRUM5,
    "tpu_multipod": TPU_MULTIPOD,
}

#: every preset name accepted by ``get_topology`` / ``build_table``
PRESETS: Tuple[str, ...] = tuple(sorted(GROUPED_PRESETS)) + ("torus",)

Topo = Union[GroupedTopo, TorusTopo]


def torus_dims(p: int, ndims: int = 3) -> Tuple[int, ...]:
    """Near-balanced power-of-two torus factorization of ``p``.

    Distributes the log2 factors round-robin so the dims differ by at most
    one power of two, e.g. 64 -> (4, 4, 4), 32 -> (4, 4, 2), 8 -> (2, 2, 2).
    """
    if p <= 0 or p & (p - 1):
        raise ValueError(f"torus preset needs a power-of-two p, got {p}")
    dims = [1] * ndims
    s = p.bit_length() - 1
    for i in range(s):
        dims[i % ndims] *= 2
    return tuple(sorted(dims, reverse=True))


def get_topology(name: str, p: int) -> Topo:
    """Resolve a preset name (and rank count, for the torus) to a topology."""
    if name in GROUPED_PRESETS:
        return GROUPED_PRESETS[name]
    if name == "torus":
        return TorusTopo("torus", torus_dims(p))
    raise KeyError(f"unknown topology preset {name!r}; known: {PRESETS}")


def tier_split(name: str, p: int) -> Tuple[int, ...]:
    """Derive the hierarchical tier stack (innermost first) a grouped
    preset induces on ``p`` ranks, for ``core.schedules.compose`` /
    ``collectives.api`` backend="bine_hier".

    Tiers follow the machine's physical hierarchy: ranks within a node
    (``node_size``), nodes within a group (``group_size``), then groups.
    Each boundary contributes the largest divisor of the remaining rank
    count not exceeding the level's capacity — a greedy split, so a tier
    that cannot divide ``p`` evenly folds into the next level out rather
    than failing.  Degenerate results collapse: ``p`` ranks all inside
    one node give the flat ``(p,)``.

    Raises ``ValueError`` for the torus (no grouped hierarchy to derive —
    use the flat torus-mapped schedules) and unknown presets, naming the
    preset so ``api`` call sites surface actionable errors.
    """
    if name not in GROUPED_PRESETS:
        if name == "torus":
            raise ValueError(
                "preset 'torus' has no grouped hierarchy to derive tiers "
                "from; bine_hier needs a grouped preset "
                f"({', '.join(sorted(GROUPED_PRESETS))})")
        raise KeyError(f"unknown topology preset {name!r}; known: {PRESETS}")
    if p < 1:
        raise ValueError(f"tier_split needs p >= 1, got {p}")
    topo = GROUPED_PRESETS[name]
    tiers = []
    rem = p  # counts ranks at level 0, nodes after the first split
    for cap in (topo.node_size, topo.group_size):
        if rem == 1:
            break
        t = max(d for d in range(1, min(cap, rem) + 1) if rem % d == 0)
        if t > 1:
            tiers.append(t)
            rem //= t
    if rem > 1:
        tiers.append(rem)
    return tuple(tiers) or (p,)


def tier_split_or_none(name: str, p: int) -> Optional[Tuple[int, ...]]:
    """Probe variant of :func:`tier_split`: the tier stack, or ``None``
    where the preset has no grouped hierarchy to derive one from (the
    torus — its locality structure is dimension-contiguity, not nested
    fully-connected groups).

    Callers that merely need to know *whether* a hierarchy exists (e.g.
    ``topology.cost.candidates_for`` dropping ``bine_hier``, or the fleet
    placement picking its torus fallback) should branch on this instead
    of string-matching preset names; whether a preset supports a split
    does not depend on ``p``, so any valid rank count probes it.
    Unknown presets still raise ``KeyError`` naming the known set.
    """
    if name == "torus":
        return None
    return tier_split(name, p)
