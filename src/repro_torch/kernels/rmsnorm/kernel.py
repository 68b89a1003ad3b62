"""The fused RMSNorm kernel and its wrapper.

Counterpart of ``repro.kernels.rmsnorm.kernel`` (TPU kernel 7,
``rmsnorm_kernel``), CUDA C++ in ``csrc/rmsnorm.cu``: one block per row,
the row read once into shared memory, a block reduction of x² in float32,
``rsqrtf``.  A wrapper handed CPU tensors runs the plain version from
``ref.py``; handed CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build as B

from . import ref as R

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
_SIGNATURES = {
    "repro_rmsnorm": [B.VP] * 3 + [B.LL, B.INT, B.FLOAT] + [B.INT] * 3
    + [B.VP],
}
#: the row lives in shared memory as float32 (227 KB a block, less the
#: 32 partial sums)
MAX_D = 56 * 1024



def _lib():
    return B.load(SOURCE, _SIGNATURES)

def rmsnorm_kernel(x, w, eps: float = 1e-6):
    """``x [N, d]`` (float32 or bf16), ``w [d]`` of the same dtype ->
    ``[N, d]`` in ``x.dtype``.  See ``ref.rmsnorm_ref``."""
    if not B.on_cuda(x, w):
        return R.rmsnorm_ref(x, w, eps)
    B.check(x.dtype in (torch.float32, torch.bfloat16) and w.dtype == x.dtype,
            f"rmsnorm takes float32 or bfloat16 x and w of one dtype, got "
            f"{x.dtype}, {w.dtype}")
    B.check(x.dim() == 2 and w.shape == (x.shape[1],),
            f"rmsnorm needs x [N, d] and w [d], got {tuple(x.shape)} and "
            f"{tuple(w.shape)}")
    B.check(x.is_contiguous() and w.is_contiguous(),
            "rmsnorm needs contiguous x and w")
    n, d = x.shape
    B.check(0 < d <= MAX_D and n < 2 ** 31,
            f"rmsnorm takes 0 < d <= {MAX_D} and fewer than 2**31 rows, got "
            f"[{n}, {d}]")
    y = torch.empty_like(x)
    if n == 0:
        return y
    per = 16 // x.element_size()
    vec = (d % per == 0 and all(t.data_ptr() % 16 == 0 for t in (x, w, y)))
    units = d // per if vec else d
    threads = min(1024, max(32, (units + 31) // 32 * 32))
    lib = _lib()
    B.raise_on(lib.repro_rmsnorm(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), n, d, float(eps),
        int(x.dtype == torch.bfloat16), int(vec), threads, B.stream(x)),
        "rmsnorm")
    B.LAUNCHES["rmsnorm"] += 1
    return y
