"""The flash-attention kernel and its wrapper.

Counterpart of ``repro.kernels.flash_attention.kernel`` (TPU kernel 8,
``flash_attention_kernel``), CUDA C++ in ``csrc/flash_attention.cu``, two
kernels chosen by ``flash_uses_wgmma``: for bf16 a tensor-core (``wgmma``)
kernel, one warpgroup a block per (batch, query head, 64 queries), TMA
loads of Q and a 2-stage K/V ring, QK^T and PV (P split into two bf16
terms) on ``wgmma``; for float32 a CUDA-core kernel, one block
per (batch, query head, 64-row query tile).  Both keep the online softmax
in float32 and skip dead key tiles.  The kernels read strided views, so
the model's ``[B, T, heads, hd]`` tensors need no transposed copies, and
they write the output in that layout (returned as a view shaped like
``q``).

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
    "repro_flash_attention_wgmma": [B.VP] * 4 + [B.INT] * 6 + [B.LL] * 14
    + [B.INT, B.INT, B.FLOAT, B.VP],
}
#: head dims the kernels take (80: zamba2's shared attention, on the
#: tensor cores in head_dim 128's tiles, columns 80-127 zero-filled; 160:
#: pixtral-12b, in head_dim 256's tiles, columns 160-255 zero-filled)
HEAD_DIMS = (16, 32, 64, 80, 128, 160, 256)


def _lib():
    return B.load(SOURCE, _SIGNATURES)


def flash_uses_wgmma(q, k, v) -> bool:
    """The rule that sends a flash-attention call to the tensor-core
    kernel: bf16 q, k and v with ``head_dim % 16 == 0``, every stride a
    positive multiple of 8 elements and every base address 16-byte
    aligned (TMA's rule).  Every other call, float32 among them, runs the
    CUDA-core kernel."""
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] % 16 == 0
            and all(s > 0 and s % 8 == 0
                    for t in (q, k, v) for s in t.stride()[:-1])
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            Bn, nkv, g, Tq, Tk, hd, *q.stride()[:4], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:4],
            0 if window is None else int(window), int(causal), float(scale))
    if flash_uses_wgmma(q, k, v):
        B.check(Tq <= 64 * 65535, f"flash_attention Tq {Tq} out of range")
        B.raise_on(_lib().repro_flash_attention_wgmma(*args, B.stream(q)),
                   "flash_attention_wgmma")
        B.LAUNCHES["flash_attention_wgmma"] += 1
    else:
        B.raise_on(_lib().repro_flash_attention(
            *args, int(q.dtype == torch.bfloat16), B.stream(q)),
            "flash_attention")
    B.LAUNCHES["flash_attention"] += 1
    return out
