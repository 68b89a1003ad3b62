"""Stacked entry points of the ``pallas_fused`` collective backend.

Counterpart of ``repro.kernels.collectives.ops`` (the bine and recdoub
butterfly families).  Same schedules as ``collectives.stacked`` and the
same exchange (one rank-dim gather per step), but every step's local work
is one kernel launch over all p ranks:

  * butterfly RS: the keep-slice, the reduction and the next step's
    send-half pack are one ``rs_step`` (the first step's pack is a plain
    slice — there is no earlier kernel to fuse it into);
  * butterfly AG: the concat/concat/select triple is one ``ag_step``;
  * int8 wire: ``rs_step_q`` decodes, accumulates and re-quantizes in one
    pass; the AG moves the int8 payload through ``ag_step`` and merges the
    scales (1/256 of the payload) as plain concats.

Arithmetic order matches the stacked executor, so results are bitwise
equal to it.
"""

from __future__ import annotations

import torch

from repro_torch.collectives import compression as comp
from repro_torch.collectives import stacked
from repro_torch.collectives.stacked import (_pad_to, butterfly, merge,
                                             permute, permute_blocks,
                                             rank_bits, take_half)
from repro_torch.core import tables as tb

from . import kernel as K


# ---------------------------------------------------------------------------
# Butterfly cores
# ---------------------------------------------------------------------------

def _rs_core_fused(buf: torch.Tensor, bt: tb.ButterflyTables) -> torch.Tensor:
    c = rank_bits(bt.cbit[0], buf.device)
    send = take_half(buf, 1 - c)
    for i in range(bt.s):
        recv = permute(send, bt.perms[i])
        if i + 1 < bt.s:
            c_next = rank_bits(bt.cbit[i + 1], buf.device)
            buf, send = K.rs_step(buf, recv, c, c_next)
            c = c_next
        else:
            buf = K.rs_step(buf, recv, c)
    return buf


def _ag_core_fused(buf: torch.Tensor, bt: tb.ButterflyTables) -> torch.Tensor:
    for i in range(bt.s - 1, -1, -1):
        recv = permute(buf, bt.perms[i])
        buf = K.ag_step(buf, recv, rank_bits(bt.cbit[i], buf.device))
    return buf


# ---------------------------------------------------------------------------
# int8-wire butterfly cores (quantized payload, f32 accumulation in-kernel)
# ---------------------------------------------------------------------------

def _rs_core_fused_q(buf: torch.Tensor, bt: tb.ButterflyTables) -> torch.Tensor:
    """Each step moves the (q, scales) pair the previous ``rs_step_q``
    re-quantized; the first step's pack is a plain slice + quantize."""
    c = rank_bits(bt.cbit[0], buf.device)
    q, s = comp.quantize_wire(take_half(buf, 1 - c))
    for i in range(bt.s):
        rq = permute(q, bt.perms[i])
        rs = permute(s, bt.perms[i])
        if i + 1 < bt.s:
            c_next = rank_bits(bt.cbit[i + 1], buf.device)
            buf, q, s = K.rs_step_q(buf, rq, rs, c, c_next)
            c = c_next
        else:
            buf = K.rs_step_q(buf, rq, rs, c)
    return buf


def _ag_core_fused_q(q: torch.Tensor, s: torch.Tensor, bt: tb.ButterflyTables):
    for i in range(bt.s - 1, -1, -1):
        rq = permute(q, bt.perms[i])
        rs = permute(s, bt.perms[i])
        c = rank_bits(bt.cbit[i], q.device)
        q = K.ag_step(q, rq, c)
        s = merge(s, rs, c)
    return q, s


def reduce_scatter_q(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """int8-wire fused reduce-scatter ``[p, n]`` -> ``[p, n/p]`` float32,
    bitwise equal to ``stacked.reduce_scatter_q``.  A per-rank block that
    is not 256-aligned goes to the stacked int8 path, as in the
    reference."""
    p = x.shape[0]
    v = x.reshape(p, -1).to(torch.float32)
    if p == 1:
        return v.reshape(x.shape)
    bt = stacked._int8_tables(algo, p)
    if v.shape[1] % p:
        raise ValueError("reduce_scatter needs len divisible by p")
    if (v.shape[1] // p) % comp.WIRE_CHUNK:
        return stacked.reduce_scatter_q(v, algo)
    return _rs_core_fused_q(permute_blocks(v, bt.inv_final), bt)


def allgather_q(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """int8-wire fused allgather ``[p, blk]`` -> ``[p, p*blk]`` float32."""
    p = x.shape[0]
    v = x.reshape(p, -1).to(torch.float32)
    if p == 1:
        return v
    bt = stacked._int8_tables(algo, p)
    q, s = _ag_core_fused_q(*comp.quantize_wire(v), bt)
    return comp.dequantize_wire(permute_blocks(q, bt.final_block),
                                permute_blocks(s, bt.final_block))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def reduce_scatter(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """``[p, n]`` (n % p == 0) -> ``[p, n/p]``: rank r's reduced block r."""
    p = x.shape[0]
    if p == 1:
        return x
    bt = butterfly(algo, p)
    v = x.reshape(p, -1)
    if v.shape[1] % p:
        raise ValueError("reduce_scatter needs len divisible by p")
    return _rs_core_fused(permute_blocks(v, bt.inv_final), bt)


def allgather(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """``[p, blk]`` -> ``[p, p*blk]``, blocks in rank order."""
    p = x.shape[0]
    if p == 1:
        return x
    bt = butterfly(algo, p)
    return permute_blocks(_ag_core_fused(x.reshape(p, -1), bt),
                          bt.final_block)


def allreduce(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """Large-vector allreduce of ``x [p, ...]``: fused RS + fused AG."""
    p = x.shape[0]
    if p == 1:
        return x
    bt = butterfly(algo, p)
    v, n = _pad_to(x.reshape(p, -1), p)
    full = _ag_core_fused(_rs_core_fused(v, bt), bt)
    return full[:, :n].reshape(x.shape)


def reduce_scatter_dim(x: torch.Tensor, dim: int, algo: str = "bine"):
    """Dim-general fused RS (the per-leaf ZeRO path): the flat fused core
    over a dim-fronted view.  ``dim`` is the per-rank dim."""
    p = x.shape[0]
    if p == 1:
        return x
    if x.shape[dim + 1] % p:
        raise ValueError((tuple(x.shape), dim, p))
    xm = torch.movedim(x, dim + 1, 1)
    flat = reduce_scatter(xm.reshape(p, -1), algo)
    out_shape = (p, xm.shape[1] // p) + tuple(xm.shape[2:])
    return torch.movedim(flat.reshape(out_shape), 1, dim + 1)


def allgather_dim(x: torch.Tensor, dim: int, algo: str = "bine"):
    """Inverse of :func:`reduce_scatter_dim`: gather blocks along ``dim``."""
    p = x.shape[0]
    if p == 1:
        return x
    xm = torch.movedim(x, dim + 1, 1)
    flat = allgather(xm.reshape(p, -1), algo)
    out_shape = (p, xm.shape[1] * p) + tuple(xm.shape[2:])
    return torch.movedim(flat.reshape(out_shape), 1, dim + 1)
