"""The dequantize-accumulate kernel and its wrapper.

Counterpart of ``repro.kernels.qdot.kernel`` (TPU kernel 9,
``qacc_kernel``), CUDA C++ in ``csrc/qacc.cu``: one elementwise pass,
``acc + float(q) * scale`` rounded twice like the plain version, so the
two are bitwise equal.  A wrapper handed CPU tensors runs the plain
version from ``ref.py``; handed CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as B

from . import ref as R

SOURCE = Path(__file__).resolve().parent / "csrc" / "qacc.cu"
_SIGNATURES = {
    "repro_qacc": [B.VP] * 4 + [B.LL, B.LL] + [B.INT] * 3 + [B.VP],
    "repro_qacc_blocks_per_sm": [B.INT, ctypes.POINTER(ctypes.c_int)],
}

#: threads a block (``qacc.cu`` kThreads)
QACC_THREADS = 256
#: float4 vectors a thread of the vector kernel holds (kUnroll)
QACC_UNROLL = 4
#: waves of resident blocks (blocks per SM x SMs) the grid spans at most
QACC_WAVES = 2

#: (C, chunk, aligned, device index) -> launch
_PLANS: dict = {}


def _lib():
    return B.load(SOURCE, _SIGNATURES)


def qacc_launch(C: int, chunk: int, aligned: bool, wave: int):
    """The launch over ``C`` rows of ``chunk``: ``(vec, shift, grid)``.
    The vector kernel (float4 of acc and out, 4 bytes of q a lane,
    ``QACC_UNROLL`` a thread) takes ``chunk % 4 == 0`` when acc and out
    are 16-byte and q 4-byte ``aligned``; the element-wise kernel the
    rest.  ``shift``: log2(chunk) for a power-of-two chunk (the scale's
    row a shift), else -1 (a division).  ``grid``: enough blocks to cover
    the elements in one iteration, at most ``QACC_WAVES`` waves of
    ``wave`` resident blocks, at least 1."""
    vec = aligned and chunk % 4 == 0
    shift = chunk.bit_length() - 1 if chunk > 0 and chunk & (chunk - 1) == 0 \
        else -1
    units, per = ((C * chunk // 4, QACC_THREADS * QACC_UNROLL) if vec
                  else (C * chunk, QACC_THREADS))
    return vec, shift, max(1, min(-(-units // per), QACC_WAVES * wave))


def qacc_kernel(q, scales, acc):
    """``q [C, chunk]`` int8, ``scales [C, 1]`` float32, ``acc [C, chunk]``
    float32 -> ``acc + q.float() * scales`` as a new float32 tensor.  The
    launch (``qacc_launch``) is cached per shape, alignment and device;
    check messages are built only on failure."""
    if not B.on_cuda(q, scales, acc):
        return R.dequant_accumulate_ref(q, scales, acc)
    if not (q.dtype == torch.int8 and scales.dtype == torch.float32
            and acc.dtype == torch.float32):
        raise ValueError(f"qacc takes int8 q, float32 scales and acc, got "
                         f"{q.dtype}, {scales.dtype}, {acc.dtype}")
    if not (q.dim() == 2 and acc.shape == q.shape
            and scales.shape == (q.shape[0], 1)):
        raise ValueError(f"qacc needs q, acc [C, chunk] and scales [C, 1], "
                         f"got {tuple(q.shape)}, {tuple(acc.shape)}, "
                         f"{tuple(scales.shape)}")
    if not (q.is_contiguous() and scales.is_contiguous()
            and acc.is_contiguous()):
        raise ValueError("qacc needs contiguous inputs")
    c, chunk = q.shape
    out = torch.empty_like(acc)
    if out.numel() == 0:
        return out
    qp, ap = q.data_ptr(), acc.data_ptr()
    aligned = ap & 15 == 0 and qp & 3 == 0      # out is fresh: aligned
    dev = acc.get_device()
    key = (c, chunk, aligned, dev)
    plan = _PLANS.get(key)
    if plan is None:
        vec = int(aligned and chunk % 4 == 0)      # qacc_launch's kernel
        wave = B.wave(("qacc", vec), dev, lambda blocks:
                      _lib().repro_qacc_blocks_per_sm(vec, blocks))
        plan = _PLANS[key] = qacc_launch(c, chunk, aligned, wave)
    B.raise_on(_lib().repro_qacc(qp, scales.data_ptr(), ap, out.data_ptr(),
                                 c, chunk, plan[0], plan[1], plan[2],
                                 B.stream(q)), "qacc")
    B.LAUNCHES["qacc"] += 1
    return out
