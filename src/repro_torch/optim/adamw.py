"""AdamW with fp32 master weights, leaf-at-a-time (ZeRO-friendly).

Port of ``repro.optim.adamw``.  The functions are shape-agnostic, so they
run the same on a full leaf, on a 1/n_dp shard, or on a stacked
``[p, ...]`` shard of every rank at once.  Scalars are float32 tensors, as
in the reference, so the schedule rounds the same way.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac·lr (float32 tensor)."""
    step = _f32(step)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init_leaf(param_slice) -> Dict[str, torch.Tensor]:
    """Optimizer state for one (possibly sliced) leaf: fp32 master + m + v."""
    master = param_slice.to(torch.float32, copy=True)
    return {"master": master, "m": torch.zeros_like(master),
            "v": torch.zeros_like(master)}


def adamw_update_leaf(cfg: AdamWConfig, st: Dict, grad, step, lr
                      ) -> Tuple[torch.Tensor, Dict]:
    """One AdamW step on a leaf slice.  Returns (new_param_slice_f32, state).

    Updates ``st``'s master, m and v IN PLACE (the port's train step hands
    its optimizer state over, as the reference step donates it), with the
    reference's operations in the reference's order, so the values are
    those of the out-of-place formula."""
    g = grad.to(torch.float32)
    m, v, master = st["m"], st["v"], st["master"]
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * (g * g))
    t = _f32(step).to(g.device) + 1.0
    mhat = m / (1 - torch.pow(cfg.b1, t))
    upd = mhat / (torch.sqrt(v / (1 - torch.pow(cfg.b2, t))) + cfg.eps)
    del mhat
    upd += cfg.weight_decay * master
    master.sub_(lr * upd)
    return master, st
