"""Plain PyTorch versions of the fused collective kernels.

Counterpart of ``repro.kernels.collectives.ref``, stacked over p ranks:
``buf [p, 2h]``, ``recv [p, h]`` and per-rank ``c``/``c_next``/``ridx``
int32 ``[p]``.  Each function states the semantics its CUDA kernel in
``csrc/`` reproduces (bitwise for the step kernels, within a stated
tolerance for the matmul), and is what the kernel's wrapper runs for a
tensor that lies on the CPU.
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


def ring_update_ref(v, recv, ridx, accumulate=True, return_updated=False):
    """One ring step for every rank, IN PLACE: block ``ridx[r]`` of row r of
    ``v [p, P*b]`` (blocks of ``b = recv.shape[1]``) gets ``cur + recv[r]``
    (``accumulate``, the reduce-scatter) or ``recv[r]`` (the allgather);
    the other blocks are not touched.  Returns ``v``, and with
    ``return_updated`` also the updated blocks ``[p, b]`` (a new tensor):
    the next ring step's send."""
    p, b = recv.shape
    ar = torch.arange(p, device=v.device)
    blocks = v.view(p, -1, b)
    idx = ridx.long()
    new = blocks[ar, idx] + recv if accumulate else recv
    blocks[ar, idx] = new
    if return_updated:
        return v, new
    return v


def dot_ref(x, w):
    """``x @ w`` as the reference computes it: both sides in float32,
    float32 products and sums (no TF32), cast to ``result_type(x, w)``."""
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return y.to(torch.result_type(x, w))


def row_blocks(a, perm):
    """Row-block ``b`` of each rank's ``a [p, m, ...]`` <- row-block
    ``perm[b]``, ``len(perm)`` blocks."""
    p, m = a.shape[:2]
    nb = perm.shape[0]
    return a.reshape((p, nb, m // nb) + tuple(a.shape[2:])).index_select(
        1, perm.long()).reshape(a.shape)


def matmul_pack_ref(x, w, perm):
    """``x [p, m, k] @ w [p, k, n]`` rank by rank, output row-block ``b``
    holding the product's row-block ``perm[b]``: the reduce-scatter's
    block pre-permute folded into the matmul's output writes."""
    return row_blocks(dot_ref(x, w), perm)


def gather_matmul_ref(xg, w, perm):
    """``xg [p, m, k]`` with row-block ``b`` <- row-block ``perm[b]``, then
    ``@ w``: the allgather's final un-permute folded into the matmul's
    LHS reads."""
    return dot_ref(row_blocks(xg, perm), w)
