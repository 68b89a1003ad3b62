"""Public wrapper of the dequantize-accumulate kernel (the port of
``repro.kernels.qdot.ops``)."""

from __future__ import annotations

from .kernel import qacc_kernel


def dequant_accumulate(q, scales, acc):
    """``q [C, chunk]`` int8, ``scales [C, 1]`` float32, ``acc [C, chunk]``
    float32 -> ``acc + q.float() * scales`` (float32)."""
    return qacc_kernel(q, scales, acc)
