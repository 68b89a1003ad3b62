"""The flash-attention kernel and its wrapper.

Counterpart of ``repro.kernels.flash_attention.kernel`` (TPU kernel 8,
``flash_attention_kernel``), CUDA C++ in ``csrc/flash_attention.cu``: one
block per (batch, query head, 64-row query tile), K/V tiles staged through
shared memory, the online softmax and both products in float32 on the CUDA
cores, dead key tiles skipped.  The kernel reads strided views, so the
model's ``[B, T, heads, hd]`` tensors need no transposed copies, and it
writes its output in that layout (returned as a view shaped like ``q``).

A wrapper handed CPU tensors runs the plain version from ``ref.py``;
handed CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels import build as B

from . import ref as R

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_SIGNATURES = {
    "repro_flash_attention": [B.VP] * 4 + [B.INT] * 6 + [B.LL] * 14
    + [B.INT, B.INT, B.FLOAT, B.INT, B.VP],
}
HEAD_DIMS = (16, 32, 64, 128)



def _lib():
    return B.load(SOURCE, _SIGNATURES)

def flash_attention_kernel(q, k, v, *, window=None, causal: bool = True,
                           scale=None):
    """q: [B, nkv, g, Tq, hd]; k, v: [B, nkv, Tk, hd] -> like q.

    Any strides with the head dim contiguous.  Every key ``< Tk`` is
    valid (``ops.flash_attention`` pads)."""
    if not B.on_cuda(q, k, v):
        return R.flash_attention_ref(q, k, v, window=window, causal=causal,
                                     scale=scale)
    B.check(q.dtype in (torch.float32, torch.bfloat16)
            and k.dtype == q.dtype and v.dtype == q.dtype,
            f"flash_attention takes float32 or bfloat16 q, k, v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B.check(q.dim() == 5 and k.dim() == 4 and v.shape == k.shape,
            f"flash_attention needs q [B, nkv, g, Tq, hd] and k, v "
            f"[B, nkv, Tk, hd], got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    Bn, nkv, g, Tq, hd = q.shape
    Tk = k.shape[2]
    B.check(k.shape[:2] == (Bn, nkv) and k.shape[3] == hd,
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    B.check(hd in HEAD_DIMS, f"flash_attention takes head_dim in "
            f"{HEAD_DIMS}, got {hd}")
    B.check(all(t.stride(-1) == 1 for t in (q, k, v)),
            "flash_attention needs the head dim contiguous")
    B.check(0 < Bn * nkv * g < 65536 and 0 < Tq < 2 ** 31 and 0 < Tk < 2 ** 31,
            f"flash_attention grid out of range: {tuple(q.shape)}")
    if window is not None:
        B.check(window > 0, f"window must be positive, got {window}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    # written in the model's [B, Tq, nkv, g, hd] layout, returned as q's
    out = torch.empty((Bn, Tq, nkv, g, hd), dtype=q.dtype,
                      device=q.device).permute(0, 2, 3, 1, 4)
    lib = _lib()
    B.raise_on(lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        Bn, nkv, g, Tq, Tk, hd, *q.stride()[:4], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:4],
        0 if window is None else int(window), int(causal), float(scale),
        int(q.dtype == torch.bfloat16), B.stream(q)), "flash_attention")
    B.LAUNCHES["flash_attention"] += 1
    return out
