"""Parameter trees across the JAX and PyTorch packages, as numpy.

Both packages keep one tree layout — nested dicts, ``segments[i]`` leaves
stacked ``[n_layers, ...]`` — and flatten it in one order (dict keys
sorted), so a tree crosses leaf for leaf.  bfloat16 leaves cross as
float32 numpy arrays (exact widening), since numpy has no bfloat16.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as T


def params_from_numpy(tree: Any, cfg, device="cuda") -> Any:
    """A numpy parameter tree (e.g. ``jax.tree.map(np.asarray, params)``)
    -> the port's tree of ``cfg.dtype`` tensors on ``device``."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)

    def one(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":   # ml_dtypes: widen exactly first
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a, copy=True)).to(dev, dt)

    return T.tree_map(one, tree)


def params_to_numpy(tree: Any) -> Any:
    """The port's tensor tree -> numpy; bfloat16 leaves as float32."""
    def one(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()

    return T.tree_map(one, tree)
