"""The fused RMSNorm kernel and its wrapper.

Counterpart of ``repro.kernels.rmsnorm.kernel`` (TPU kernel 7,
``rmsnorm_kernel``), CUDA C++ in ``csrc/rmsnorm.cu``: the row held in
registers (16-byte vectors, every load issued before the arithmetic), one
barrier per row, a one-wave grid whose blocks walk rows with a stride and
keep ``w`` in registers, ``rsqrtf``.  ``launch_shape`` is the launch
rule.  A wrapper handed CPU tensors runs the plain version from
``ref.py``; handed CUDA tensors it launches the kernel or raises.

The wrapper's host time is part of the kernel's cost (it runs 65 times
per insert and per decode step), so it builds a check's message only when
the check fails, computes the launch shape once per ``(d, dtype, layout,
device)`` and reads the stream as a raw handle.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as B

from . import ref as R

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
_SIGNATURES = {
    "repro_rmsnorm": [B.VP] * 3 + [B.LL, B.INT, B.FLOAT] + [B.INT] * 5
    + [B.VP],
    "repro_rmsnorm_blocks_per_sm": [B.INT] * 4
    + [ctypes.POINTER(ctypes.c_int)],
}
#: the largest row the wrapper takes (rows past the register budget run the
#: kernel's loop over the row)
MAX_D = 56 * 1024
#: threads a block at most (``rmsnorm.cu``'s launch bound: 128 registers
#: a thread)
MAX_THREADS = 512
#: 16-byte vectors a thread holds in registers at most (x and w, 4
#: registers a vector each)
MAX_VPT = 4
#: vectors a thread holds when the row allows it (bf16 d = 3072: 128
#: threads of 3)
VPT_TARGET = 3

#: (d, dtype, layout mode, device index) -> (threads, vpt, one wave); mode
#: 0 one element a vector, 1 16-byte vectors, 2 the vectors' layout read
#: element by element (a pointer off 16 bytes)
_PLANS: dict = {}


def _lib():
    return B.load(SOURCE, _SIGNATURES)


def launch_shape(n: int, d: int, itemsize: int, vec: bool, wave: int):
    """The launch of ``n`` rows of ``d`` elements of ``itemsize`` bytes:
    ``(threads, vpt, grid)``.  A thread holds ``vpt`` vectors of 16 bytes
    (of one element without ``vec``): threads are a multiple of 32 from
    32 to ``MAX_THREADS``, about a third of the row's vectors; ``vpt`` is
    what covers the row, or 0 (the kernel's loop over the row) past
    ``MAX_VPT``.  The
    grid is one wave (``wave`` = resident blocks per SM x SMs) or ``n``
    if fewer; each block walks rows with a stride.  The wrapper caches
    threads, vpt and the wave per key and takes ``min(n, wave)`` per
    call."""
    nv = d // (16 // itemsize) if vec else d
    threads = min(MAX_THREADS, max(32, -(-nv // (32 * VPT_TARGET)) * 32))
    vpt = -(-nv // threads)
    return threads, (vpt if vpt <= MAX_VPT else 0), min(n, wave)


def _plan(d: int, dtype, mode: int, dev: int):
    bf16 = dtype == torch.bfloat16
    threads, vpt, _ = launch_shape(1, d, 2 if bf16 else 4, mode != 0, 1)
    blocks = ctypes.c_int(0)
    B.raise_on(_lib().repro_rmsnorm_blocks_per_sm(
        int(bf16), mode, vpt, threads, ctypes.byref(blocks)),
        "rmsnorm occupancy")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = _PLANS[(d, dtype, mode, dev)] = (threads, vpt,
                                             max(1, blocks.value) * sms)
    return plan


def rmsnorm_kernel(x, w, eps: float = 1e-6):
    """``x [N, d]`` (float32 or bf16), ``w [d]`` of the same dtype ->
    ``[N, d]`` in ``x.dtype``.  See ``ref.rmsnorm_ref``."""
    if not B.on_cuda(x, w):     # both on the CPU; anything else raises
        return R.rmsnorm_ref(x, w, eps)
    dtype = x.dtype
    if not ((dtype == torch.float32 or dtype == torch.bfloat16)
            and w.dtype == dtype):
        raise ValueError(f"rmsnorm takes float32 or bfloat16 x and w of one "
                         f"dtype, got {x.dtype}, {w.dtype}")
    if not (x.dim() == 2 and w.dim() == 1 and w.shape[0] == x.shape[1]):
        raise ValueError(f"rmsnorm needs x [N, d] and w [d], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm needs contiguous x and w")
    n, d = x.shape
    if not (0 < d <= MAX_D and n < 2 ** 31):
        raise ValueError(f"rmsnorm takes 0 < d <= {MAX_D} and fewer than "
                         f"2**31 rows, got [{n}, {d}]")
    y = torch.empty_like(x)
    if n == 0:
        return y
    xp, wp, yp = x.data_ptr(), w.data_ptr(), y.data_ptr()
    bf16 = dtype == torch.bfloat16
    # the vector layout wherever d allows it, its loads element by element
    # where a pointer is off 16 bytes (mode 2): a row's bits then depend on
    # neither its alignment nor the batch
    mode = (0 if d % (8 if bf16 else 4)
            else 1 if (xp | wp | yp) & 15 == 0 else 2)
    dev = x.get_device()
    threads, vpt, wave = (_PLANS.get((d, dtype, mode, dev))
                          or _plan(d, dtype, mode, dev))
    B.raise_on(_lib().repro_rmsnorm(
        xp, wp, yp, n, d, eps, bf16, mode, vpt, threads, min(n, wave),
        B.stream(x)), "rmsnorm")
    B.LAUNCHES["rmsnorm"] += 1
    return y
