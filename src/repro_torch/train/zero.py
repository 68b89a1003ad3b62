"""ZeRO-1 leaf partitioning: per parameter leaf, the dim that shards the
optimizer state and the gradient reduce-scatter over the DP ranks.

Port of ``zero_layout`` and ``slice_leaf`` of ``repro.train.zero``.  Rules
per leaf: candidate dims are not model-sharded (``models.sharding``) and
divide by ``n_dp``; the largest wins; no candidate -> ``-1``, the leaf
joins the replicated group (allreduced, optimizer state replicated).
The specs are those of the model axis's size ``n_model`` (pure_sp
replicates its weights, so their zero dims move), and the zero dim is
never the one a TP rank's shard is cut on: stacked TP rank t of DP rank
r holds block r along the zero dim of its own weight shard.
"""

from __future__ import annotations

from repro_torch import tree as T
from repro_torch.models.sharding import param_specs


def _choose_dim(shape, spec, n_dp: int) -> int:
    """Return zero_dim or -1 (replicated)."""
    best, best_size = -1, 0
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for d, size in enumerate(shape):
        if spec[d] is not None or size % n_dp != 0:
            continue
        if size > best_size:
            best, best_size = d, size
    return best


def zero_layout(cfg, params_shapes, n_dp: int, n_model: int = 1):
    """Tree of zero_dim ints (-1 = replicated) mirroring the (global)
    params, for a model axis of ``n_model``."""
    specs = param_specs(cfg, params_shapes, n_model)
    return T.tree_map(
        lambda leaf, spec: _choose_dim(tuple(leaf.shape), spec, n_dp),
        params_shapes, specs)


def slice_leaf(leaf, zd: int, n_dp: int, rank: int):
    """Rank ``rank``'s block of ``leaf`` along ``zd`` (the leaf if zd < 0)."""
    if zd < 0:
        return leaf
    k = leaf.shape[zd] // n_dp
    return leaf.narrow(zd, rank * k, k)
