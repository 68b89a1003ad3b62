"""Public wrapper of the fused RMSNorm kernel: any leading dims (the port
of ``repro.kernels.rmsnorm.ops``)."""

from __future__ import annotations

import torch

from .kernel import rmsnorm_kernel


def rmsnorm(x, w, eps: float = 1e-6):
    """``x [..., d]``, ``w [d]`` -> like ``x``:
    ``x·rsqrt(mean(x²)+eps)·(1+w)`` in float32, cast to ``x.dtype``.
    A gain of a narrower dtype than ``x`` (a bf16 model's gain over a
    frontend model's float32 stream) is cast to ``x.dtype`` first, which
    is exact; the kernel takes one dtype."""
    if w.dtype != x.dtype and \
            torch.promote_types(w.dtype, x.dtype) == x.dtype:
        w = w.to(x.dtype)
    shape = x.shape
    if len(shape) != 2:
        x = x.reshape(-1, shape[-1])
    if not x.is_contiguous():
        x = x.contiguous()
    if not w.is_contiguous():
        w = w.contiguous()
    out = rmsnorm_kernel(x, w, eps)
    return out if len(shape) == 2 else out.reshape(shape)
