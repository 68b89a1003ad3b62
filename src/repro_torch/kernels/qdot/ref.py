"""Plain PyTorch version of the dequantize-accumulate kernel: the port of
``repro.kernels.qdot.ref``."""

from __future__ import annotations

import torch


def dequant_accumulate_ref(q, scales, acc):
    return acc + q.to(torch.float32) * scales.to(torch.float32)
