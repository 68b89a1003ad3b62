"""Stacked entry points of the ``pallas_fused`` collective backend.

Counterpart of ``repro.kernels.collectives.ops`` (the bine, recdoub and
ring families, and the fused matmul collectives).  Same schedules as
``collectives.stacked`` and the same exchange (one rank-dim gather per
step), but every step's local work is one kernel launch over all p ranks:

  * butterfly RS: the keep-slice, the reduction and the next step's
    send-half pack are one ``rs_step`` (the first step's pack is a plain
    slice — there is no earlier kernel to fuse it into);
  * butterfly AG: the concat/concat/select triple is one ``ag_step``;
  * int8 wire: ``rs_step_q`` decodes, accumulates and re-quantizes in one
    pass; the AG moves the int8 payload through ``ag_step`` and merges the
    scales (1/256 of the payload) as plain concats;
  * ring RS/AG: the read-modify-write of the rotating block runs in place
    through ``ring_update``, whose second output is the next send (the
    caller's input is cloned once, so it is never changed);
  * ``matmul_reduce_scatter`` / ``allgather_matmul``: the tensor-parallel
    contraction absorbs the block permutation of its adjacent schedule
    step (``perm_matmul``: output writes resp. LHS reads go through the
    permuted block index).

Arithmetic order matches the stacked executor, so results are bitwise
equal to it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.collectives import compression as comp
from repro_torch.collectives import stacked
from repro_torch.collectives.stacked import (_pad_to, butterfly, merge,
                                             permute, permute_blocks,
                                             rank_bits, ring_blocks,
                                             ring_perm, take_blocks,
                                             take_half)
from repro_torch.core import tables as tb

from . import kernel as K
from . import ref as R

#: schedule families the fused kernels execute
ALGOS = ("bine", "recdoub", "ring")


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
    if algo == "ring":
        return _ring_rs_flat(x.reshape(p, -1))
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
    if algo == "ring":
        return _ring_ag_flat(x.reshape(p, -1))
    bt = butterfly(algo, p)
    return permute_blocks(_ag_core_fused(x.reshape(p, -1), bt),
                          bt.final_block)


def allreduce(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """Large-vector allreduce of ``x [p, ...]``: fused RS + fused AG."""
    p = x.shape[0]
    if p == 1:
        return x
    v, n = _pad_to(x.reshape(p, -1), p)
    if algo == "ring":
        full = _ring_ag_flat(_ring_rs_flat(v))
    else:
        bt = butterfly(algo, p)
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



# ---------------------------------------------------------------------------
# Ring (fused read-modify-write; the stacked ring's rotation)
# ---------------------------------------------------------------------------

def _ring_rs_flat(v: torch.Tensor) -> torch.Tensor:
    """``[p, n]`` -> ``[p, n/p]``.  Step t sends block ``(idx-t-1) % p`` —
    the block step t-1 just updated, so ``ring_update``'s second output IS
    the next send.  The first send is block ``(idx-1) % p``, and every add
    is ``cur + recv``: bitwise the stacked ring."""
    p = v.shape[0]
    if v.shape[1] % p:
        raise ValueError("reduce_scatter needs len divisible by p")
    blk = v.shape[1] // p
    v = v.clone(memory_format=torch.contiguous_format)   # updated in place
    perm = ring_perm(p)
    send = take_blocks(v, ring_blocks(p, 1, v.device), 1, blk)
    for t in range(p - 1):
        recv = permute(send, perm)
        ridx = rank_bits((np.arange(p) - t - 2) % p, v.device)
        if t + 1 < p - 1:
            v, send = K.ring_update(v, recv, ridx, accumulate=True,
                                    return_updated=True)
        else:
            K.ring_update(v, recv, ridx, accumulate=True)
    return take_blocks(v, ring_blocks(p, 0, v.device), 1, blk)


def _ring_ag_flat(block: torch.Tensor) -> torch.Tensor:
    """``[p, blk]`` -> ``[p, p*blk]``: step t forwards what step t-1
    delivered and ``ring_update`` writes it into block ``(idx-t-1) % p``."""
    p, blk = block.shape
    v = block.new_zeros((p, p * blk))
    K.ring_update(v, block.contiguous(), rank_bits(np.arange(p), v.device),
                  accumulate=False)
    perm = ring_perm(p)
    send = block
    for t in range(p - 1):
        recv = permute(send, perm)
        K.ring_update(v, recv, rank_bits((np.arange(p) - t - 1) % p, v.device),
                      accumulate=False)
        send = recv
    return v


# ---------------------------------------------------------------------------
# Fused matmul + schedule-edge collectives (tensor-parallel contraction)
# ---------------------------------------------------------------------------

def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor,
                          algo: str = "bine") -> torch.Tensor:
    """``reduce_scatter(x @ w)`` over the ranks, rows scattered: ``x [p, m,
    k]``, ``w [p, k, n]`` -> ``[p, m/p, n]``, rank r holding rows ``[r*m/p,
    (r+1)*m/p)`` of the rank-summed product.  The matmul writes straight
    into the reduce-scatter's pre-permuted block layout."""
    p, m, _ = x.shape
    n = w.shape[2]
    if p == 1:      # a plain product, outside any kernel, as the reference
        return R.dot_ref(x, w)
    if m % p:
        raise ValueError(f"matmul_reduce_scatter needs m % p == 0, got "
                         f"m={m}, p={p}")
    if algo == "ring":
        perm = rank_bits(np.arange(p), x.device)   # ring scatters in order
        y = K.perm_matmul(x, w, perm, lhs_perm=False)
        out = _ring_rs_flat(y.reshape(p, -1))
    else:
        bt = butterfly(algo, p)
        y = K.perm_matmul(x, w, rank_bits(bt.inv_final, x.device),
                          lhs_perm=False)
        out = _rs_core_fused(y.reshape(p, -1), bt)
    return out.reshape(p, m // p, n)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor,
                     algo: str = "bine") -> torch.Tensor:
    """``allgather(x) @ w``: ``x [p, mb, k]`` (rank r's rows ``[r*mb,
    (r+1)*mb)``), ``w [p, k, n]`` -> ``[p, p*mb, n]`` on every rank.  The
    allgather's final block un-permute is folded into the matmul's LHS
    reads."""
    p, mb, k = x.shape
    if p == 1:
        return R.dot_ref(x, w)
    if algo == "ring":
        g = _ring_ag_flat(x.reshape(p, -1))
        perm = rank_bits(np.arange(p), x.device)
    else:
        bt = butterfly(algo, p)
        g = _ag_core_fused(x.reshape(p, -1), bt)
        perm = rank_bits(bt.final_block, x.device)
    return K.perm_matmul(g.reshape(p, p * mb, k), w, perm, lhs_perm=True)
