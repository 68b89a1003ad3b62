"""Plain PyTorch versions of the fused collective step kernels.

Counterpart of ``repro.kernels.collectives.ref``, stacked over p ranks:
``buf [p, 2h]``, ``recv [p, h]`` and per-rank ``c``/``c_next`` int32 ``[p]``.
Each function states the exact semantics its CUDA kernel in
``csrc/collective_steps.cu`` reproduces bitwise, and is what the kernel's
wrapper runs for a tensor that lies on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.collectives import compression as comp
from repro_torch.collectives.stacked import merge, take_half


def rs_step_ref(buf, recv, c, c_next=None):
    """One vector-halving reduce-scatter step for every rank.

    ``new[r] = buf[r, c[r]*h : (c[r]+1)*h] + recv[r]``.  With ``c_next``
    (every step but the last) also ``send[r] = new[r, (1-c_next[r])*q :
    +q]``, ``q = h // 2``: the next step's outgoing half.
    """
    new = take_half(buf, c) + recv
    if c_next is None:
        return new
    return new, take_half(new, 1 - c_next)


def rs_step_ref_q(buf, recv_q, recv_s, c, c_next=None):
    """int8-wire RS step: decode the partner's half (``recv_q`` int8 and
    per-``wire_chunk(h)`` f32 scales ``recv_s``), accumulate in f32 on the
    kept half and, with ``c_next``, re-quantize the next outgoing half at
    ``wire_chunk(h // 2)``."""
    new = take_half(buf, c) + comp.dequantize_wire(recv_q, recv_s)
    if c_next is None:
        return new
    q, s = comp.quantize_wire(take_half(new, 1 - c_next))
    return new, q, s


def ag_step_ref(buf, recv, c):
    """One vector-doubling allgather step: ``[buf, recv]`` where ``c == 0``,
    else ``[recv, buf]``, for any dtype."""
    return merge(buf, recv, c)
