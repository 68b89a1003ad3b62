"""Fused int8 dequantize-accumulate on a hand-written Hopper kernel
(``repro.kernels.qdot``)."""

from .ops import dequant_accumulate
from .ref import dequant_accumulate_ref

__all__ = ["dequant_accumulate", "dequant_accumulate_ref"]
