"""Parameter trees across the JAX and PyTorch packages, as numpy.

Both packages keep one tree layout — nested dicts, ``segments[i]`` leaves
stacked ``[n_layers, ...]`` — and flatten it in one order (dict keys
sorted), so a tree crosses leaf for leaf.  bfloat16 leaves cross as
float32 numpy arrays (exact widening), since numpy has no bfloat16.
The train state crosses as its global (logical) arrays
(``train_state_to_numpy`` / ``train_state_from_numpy``, on
``train.step.to_global`` / ``from_global``); checkpoints carry bfloat16
bit for bit (``train.checkpoint``).  Under tensor parallelism
(``n_model`` / ``tp`` > 1) the port's side is stacked over the TP ranks
(``models.sharding.shard_params``) and the numpy side stays global, as
the reference's arrays are.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as T


def params_from_numpy(tree: Any, cfg, device="cuda", n_model: int = 1
                      ) -> Any:
    """A numpy parameter tree (e.g. ``jax.tree.map(np.asarray, params)``)
    -> the port's tree of tensors on ``device``, each leaf in its dtype
    of ``models.transformer.param_shapes(cfg)`` (``cfg.dtype``, or
    float32 for Mamba2's SSM leaves, as the reference keeps them), stacked
    over ``n_model`` TP ranks when it is above 1."""
    from repro_torch.models.transformer import param_shapes
    dev = resolve_device(device)

    def one(x, like):
        return _from_np(x).to(dev, like.dtype)

    out = T.tree_map(one, tree, param_shapes(cfg))
    if n_model > 1:
        from repro_torch.models.sharding import shard_params
        out = shard_params(cfg, out, n_model)
    return out


def params_to_numpy(tree: Any, cfg=None, n_model: int = 1) -> Any:
    """The port's tensor tree -> numpy; bfloat16 leaves as float32.  A tree
    stacked over ``n_model > 1`` TP ranks is joined into the global one
    (``cfg`` names the model)."""
    if n_model > 1:
        from repro_torch.models.sharding import unshard_params
        from repro_torch.models.transformer import param_shapes
        tree = unshard_params(cfg, tree, n_model, param_shapes(cfg))
    return T.tree_map(_np_leaf, tree)


def _from_np(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":   # ml_dtypes: widen exactly first
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True))


def _np_leaf(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.numpy()


def train_state_to_numpy(model_cfg, tcfg, params, state, dp, tp: int = 1
                         ) -> Any:
    """The stacked per-rank ``params`` and ``state`` (DP sizes ``dp``,
    model axis ``tp``) as the global numpy tree ``{"params", "state"}``
    (``train.step.to_global``), which the reference's step holds as its
    global arrays; bfloat16 leaves as float32."""
    from repro_torch.train.step import to_global
    return T.tree_map(_np_leaf, to_global(model_cfg, tcfg, params, state,
                                          dp, device="cpu", tp=tp))


def train_state_from_numpy(model_cfg, tcfg, tree: Any, dp, device="cuda",
                           tp: int = 1):
    """Inverse of :func:`train_state_to_numpy` at the DP sizes ``dp`` and
    model axis ``tp``: ``(params, state)`` stacked on ``device``.  Params
    take their dtypes of ``param_shapes`` (as :func:`params_from_numpy`),
    the optimizer state and residuals float32, the step int32."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.step import from_global

    def one(dtype):
        return lambda x: _from_np(x).to(dtype)

    st = tree["state"]
    glob = {"params": T.tree_map(lambda x, like: _from_np(x).to(like.dtype),
                                 tree["params"], param_shapes(model_cfg)),
            "state": {"opt": T.tree_map(one(torch.float32), st["opt"]),
                      "step": one(torch.int32)(st["step"])}}
    if "ef" in st:
        glob["state"]["ef"] = T.tree_map(one(torch.float32), st["ef"])
    return from_global(model_cfg, tcfg, glob, dp, device, tp=tp)
