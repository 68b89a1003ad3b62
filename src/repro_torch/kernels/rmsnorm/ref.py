"""Plain PyTorch version of the fused RMSNorm kernel: the port of
``repro.kernels.rmsnorm.ref``."""

from __future__ import annotations

import torch


def rmsnorm_ref(x, w, eps: float = 1e-6):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.to(torch.float32))).to(x.dtype)
