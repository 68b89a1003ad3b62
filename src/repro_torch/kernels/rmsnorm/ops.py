"""Public wrapper of the fused RMSNorm kernel: any leading dims (the port
of ``repro.kernels.rmsnorm.ops``)."""

from __future__ import annotations

from .kernel import rmsnorm_kernel


def rmsnorm(x, w, eps: float = 1e-6):
    """``x [..., d]``, ``w [d]`` -> like ``x``:
    ``x·rsqrt(mean(x²)+eps)·(1+w)`` in float32, cast to ``x.dtype``."""
    shape = x.shape
    d = shape[-1]
    out = rmsnorm_kernel(x.reshape(-1, d).contiguous(), w.contiguous(), eps)
    return out.reshape(shape)
