"""The dequantize-accumulate kernel and its wrapper.

Counterpart of ``repro.kernels.qdot.kernel`` (TPU kernel 9,
``qacc_kernel``), CUDA C++ in ``csrc/qacc.cu``: one elementwise pass,
``acc + float(q) * scale`` rounded twice like the plain version, so the
two are bitwise equal.  A wrapper handed CPU tensors runs the plain
version from ``ref.py``; handed CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build as B

from . import ref as R

SOURCE = Path(__file__).resolve().parent / "csrc" / "qacc.cu"
_SIGNATURES = {"repro_qacc": [B.VP] * 4 + [B.LL, B.LL, B.INT, B.VP]}



def _lib():
    return B.load(SOURCE, _SIGNATURES)

def qacc_kernel(q, scales, acc):
    """``q [C, chunk]`` int8, ``scales [C, 1]`` float32, ``acc [C, chunk]``
    float32 -> ``acc + q.float() * scales`` as a new float32 tensor."""
    if not B.on_cuda(q, scales, acc):
        return R.dequant_accumulate_ref(q, scales, acc)
    B.check(q.dtype == torch.int8 and scales.dtype == torch.float32
            and acc.dtype == torch.float32,
            f"qacc takes int8 q, float32 scales and acc, got {q.dtype}, "
            f"{scales.dtype}, {acc.dtype}")
    B.check(q.dim() == 2 and acc.shape == q.shape
            and scales.shape == (q.shape[0], 1),
            f"qacc needs q, acc [C, chunk] and scales [C, 1], got "
            f"{tuple(q.shape)}, {tuple(acc.shape)}, {tuple(scales.shape)}")
    B.check(all(t.is_contiguous() for t in (q, scales, acc)),
            "qacc needs contiguous inputs")
    c, chunk = q.shape
    out = torch.empty_like(acc)
    if out.numel() == 0:
        return out
    vec = (chunk % 16 == 0
           and all(t.data_ptr() % 16 == 0 for t in (q, acc, out)))
    lib = _lib()
    B.raise_on(lib.repro_qacc(q.data_ptr(), scales.data_ptr(),
                              acc.data_ptr(), out.data_ptr(), c, chunk,
                              int(vec), B.stream(q)), "qacc")
    B.LAUNCHES["qacc"] += 1
    return out
