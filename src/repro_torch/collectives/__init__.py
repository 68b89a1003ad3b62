"""Port of ``repro.collectives``: the collectives API over stacked ranks."""

from .api import (AUTO, BINE, PALLAS_FUSED, PALLAS_FUSED_BACKEND, XLA,
                  CollectiveConfig, all_to_all, allgather,
                  allreduce, allreduce_uses_small, broadcast, gather, reduce,
                  reduce_scatter, resolve_backend, scatter)

__all__ = [
    "CollectiveConfig",
    "BINE", "XLA", "AUTO", "PALLAS_FUSED", "PALLAS_FUSED_BACKEND",
    "allreduce", "reduce_scatter", "allgather", "all_to_all",
    "broadcast", "reduce", "gather", "scatter",
    "resolve_backend", "allreduce_uses_small",
]
