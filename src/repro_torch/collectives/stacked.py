"""Stacked-rank executor of the Bine collectives.

Counterpart of ``repro.collectives.shmap``.  The JAX package runs p ranks
as p devices under ``shard_map``; here they run stacked on one device:

  * every per-rank buffer is ``[p, ...]`` (row r = rank r);
  * ``lax.ppermute(x, perm)`` becomes an index gather over dim 0,
    ``out[dst] = x[src]`` (:func:`permute`); a tree step's pair list is
    not a full permutation, and a rank that receives nothing gets zeros,
    as from ``ppermute`` (:func:`permute_partial`);
  * each per-rank table entry, such as ``cbit[i][idx]``, ``recv_off[j]``
    or the ring's ``(idx - t - 1) % p``, becomes an int32 ``[p]`` tensor on
    the buffer's device, made once per table (:func:`_ints_on`).

The schedules, the operand order (``kept + recv``, ``cur + recv``) and the
quantize points are the reference's, so every result is bitwise equal to
it.  This module is the plain executor; ``kernels.collectives.ops`` runs
the same schedules with every step's local work in one CUDA kernel launch.
The XLA built-ins the reference's ``backend="xla"`` calls (``psum``,
``psum_scatter``, ``all_gather``, ``all_to_all``) are the framework's own
reductions and reshapes over the rank dim here (section at the end); a
multi-GPU executor maps them to NCCL.

Two DP axes: the reference flattens a tuple of mesh axes row-major
(``shmap.axis_index``), so the stacked ranks of a ``(pods, data)`` layout
are ``r = pod * data + d`` and a tuple-axis collective is the flat one
over all p rows.  A collective over ONE of the axes runs within each of
its groups (the ranks that differ only in that axis): :func:`over_axis`.
The schedule-IR executor (:func:`run_schedule`) runs any composed
(hierarchical) schedule of ``core.schedules.compose``.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.collectives import compression as comp
from repro_torch.core import tables as tb
from repro_torch.core.schedules import BLOCK_ALL, KIND_REDUCE, Schedule

_KIND = {"bine": "bine_dd", "recdoub": "recdoub_dd"}


def butterfly(algo: str, p: int) -> tb.ButterflyTables:
    if algo not in _KIND:
        raise ValueError(f"{algo!r} is no butterfly family; expected one of "
                         f"{sorted(_KIND)}")
    return tb.butterfly_tables(_KIND[algo], p)


def sources(perm: Sequence[Tuple[int, int]], p: int) -> np.ndarray:
    """``src[dst]`` for one ppermute pair list."""
    src = np.full(p, -1, dtype=np.int64)
    for s, d in perm:
        src[d] = s
    if (src < 0).any():
        raise ValueError(f"perm {perm} is not a full permutation of {p}")
    return src


@functools.lru_cache(maxsize=None)
def _ints_on(values: Tuple[int, ...], dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A schedule's index or bit vector on ``device``, made once, so a
    schedule step issues no host-to-device copy.  Callers only read it."""
    return torch.tensor(values, dtype=dtype, device=device)


def _ints(values, dtype: torch.dtype, device) -> torch.Tensor:
    return _ints_on(tuple(int(v) for v in np.asarray(values).ravel()), dtype,
                    torch.device(device))


def permute(x: torch.Tensor, perm) -> torch.Tensor:
    """``lax.ppermute`` on a stacked buffer: ``out[dst] = x[src]``."""
    return x.index_select(0, _ints(sources(perm, x.shape[0]), torch.int64,
                                   x.device))


def permute_partial(x: torch.Tensor, perm) -> torch.Tensor:
    """``lax.ppermute`` over a pair list that need not cover every rank (a
    tree step): ``out[dst] = x[src]``, zeros on a rank that receives
    nothing."""
    src = [s for s, _ in perm]
    dst = [d for _, d in perm]
    out = torch.zeros_like(x)
    return out.index_copy_(0, _ints(dst, torch.int64, x.device),
                           x.index_select(0, _ints(src, torch.int64,
                                                   x.device)))


def rank_rows(table, device) -> torch.Tensor:
    """A per-rank table ``[p, ...]`` as an int64 index tensor of that
    shape, made once per table."""
    a = np.asarray(table)
    return _ints(a, torch.int64, device).view(a.shape)


def rank_mask(row, x: torch.Tensor) -> torch.Tensor:
    """A per-rank bool row ``[p]`` shaped to broadcast against ``x``."""
    m = _ints(np.asarray(row, dtype=bool), torch.bool, x.device)
    return m.view(-1, *([1] * (x.dim() - 1)))


def take_blocks(v: torch.Tensor, start: torch.Tensor, nblk: int,
                blk: int) -> torch.Tensor:
    """Row r's ``nblk`` blocks from block ``start[r]`` of ``v [p, n]``."""
    p = v.shape[0]
    idx = start.view(p, 1) + torch.arange(nblk, device=v.device)
    ar = torch.arange(p, device=v.device).view(p, 1)
    return v.view(p, -1, blk)[ar, idx].reshape(p, nblk * blk)


def put_blocks(v: torch.Tensor, start: torch.Tensor, vals: torch.Tensor,
               blk: int) -> None:
    """Write ``vals [p, nblk*blk]`` into row r of ``v`` from block
    ``start[r]``, in place."""
    p = v.shape[0]
    nblk = vals.shape[1] // blk
    idx = start.view(p, 1) + torch.arange(nblk, device=v.device)
    ar = torch.arange(p, device=v.device).view(p, 1)
    v.view(p, -1, blk)[ar, idx] = vals.reshape(p, nblk, blk)


def rank_bits(row: np.ndarray, device) -> torch.Tensor:
    """One per-rank table row as an int32 ``[p]`` tensor."""
    return _ints(row, torch.int32, device)


def take_half(buf: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Row r's half ``c[r]`` of the last dim: ``buf[r, c*h:(c+1)*h]``."""
    p, n = buf.shape
    ar = torch.arange(p, device=buf.device)
    return buf.reshape(p, 2, n // 2)[ar, c.long()]


def merge(buf: torch.Tensor, recv: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``[buf, recv]`` where ``c == 0``, else ``[recv, buf]``, row by row."""
    lo = torch.cat([buf, recv], dim=-1)
    hi = torch.cat([recv, buf], dim=-1)
    return torch.where((c == 0).view(-1, *([1] * (buf.dim() - 1))), lo, hi)


def _pad_to(v: torch.Tensor, mult: int):
    """Zero-pad the last dim of ``v`` to a multiple of ``mult``."""
    n = v.shape[-1]
    pad = (-n) % mult
    if pad:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (pad,))], dim=-1)
    return v, n


def permute_blocks(v: torch.Tensor, order) -> torch.Tensor:
    """Reorder the p equal blocks of each row: block b <- block order[b]."""
    p, n = v.shape
    idx = _ints(order, torch.int64, v.device)
    return v.view(p, p, n // p).index_select(1, idx).reshape(p, n)


# ---------------------------------------------------------------------------
# Butterfly cores (vector halving / doubling) — paper Sec. 4.3
# ---------------------------------------------------------------------------

def _rs_core(buf: torch.Tensor, bt: tb.ButterflyTables) -> torch.Tensor:
    """Vector-halving reduce-scatter over ``buf [p, n]``; n % p == 0.

    Step i: send the (1-c)-half to the partner, keep the c-half, add."""
    for i in range(bt.s):
        c = rank_bits(bt.cbit[i], buf.device)
        send = take_half(buf, 1 - c)
        kept = take_half(buf, c)
        buf = kept + permute(send, bt.perms[i])
    return buf


def _ag_core(buf: torch.Tensor, bt: tb.ButterflyTables) -> torch.Tensor:
    """Vector-doubling allgather: the RS reversed."""
    for i in range(bt.s - 1, -1, -1):
        recv = permute(buf, bt.perms[i])
        buf = merge(buf, recv, rank_bits(bt.cbit[i], buf.device))
    return buf


def allreduce_butterfly(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """Large-vector allreduce of ``x [p, ...]``: RS (dist-doubling) + AG
    (dist-halving); the AG inverts the RS's block movement."""
    p = x.shape[0]
    if p == 1:
        return x
    bt = butterfly(algo, p)
    v, n = _pad_to(x.reshape(p, -1), p)
    v = _ag_core(_rs_core(v, bt), bt)
    return v[:, :n].reshape(x.shape)


def allreduce_small(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """Small-vector allreduce: recursive doubling on the distance-halving
    butterfly, the full vector each step."""
    p = x.shape[0]
    if p == 1:
        return x
    kind = {"bine": "bine_dh", "recdoub": "recdoub_dh"}[algo]
    v = x
    for perm in tb.small_butterfly_perms(kind, p):
        v = v + permute(v, perm)
    return v


def reduce_scatter(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """``x [p, n]`` (n % p == 0) -> ``[p, n/p]``: rank r's reduced block r.

    Blocks are pre-permuted by ``inv_final`` (Sec. 4.3.1) so every
    transmission is contiguous and rank r ends with block r."""
    p = x.shape[0]
    if p == 1:
        return x
    if algo == "ring":
        return _ring_reduce_scatter(x)
    bt = butterfly(algo, p)
    v = x.reshape(p, -1)
    if v.shape[1] % p:
        raise ValueError("reduce_scatter needs len divisible by p")
    return _rs_core(permute_blocks(v, bt.inv_final), bt)


def allgather(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """``x [p, blk]`` -> ``[p, p*blk]``: every rank's full vector, blocks in
    rank order."""
    p = x.shape[0]
    if p == 1:
        return x
    if algo == "ring":
        return _ring_allgather(x)
    bt = butterfly(algo, p)
    v = _ag_core(x.reshape(p, -1), bt)
    return permute_blocks(v, bt.final_block)


# ---------------------------------------------------------------------------
# int8-wire butterfly RS / AG (quantized payload, f32 accumulation)
# ---------------------------------------------------------------------------

def _rs_core_q(buf: torch.Tensor, bt: tb.ButterflyTables) -> torch.Tensor:
    """int8-wire vector-halving RS of float32 ``buf [p, n]``: each step
    quantizes the sent half at ``wire_chunk(half)``, moves (q, scales) and
    accumulates the decoded half in f32."""
    for i in range(bt.s):
        c = rank_bits(bt.cbit[i], buf.device)
        q, s = comp.quantize_wire(take_half(buf, 1 - c))
        rq = permute(q, bt.perms[i])
        rs = permute(s, bt.perms[i])
        buf = take_half(buf, c) + comp.dequantize_wire(rq, rs)
    return buf


def _ag_core_q(q: torch.Tensor, s: torch.Tensor, bt: tb.ButterflyTables):
    """int8-wire vector-doubling AG of an encoded (q, scales) pair."""
    for i in range(bt.s - 1, -1, -1):
        rq = permute(q, bt.perms[i])
        rs = permute(s, bt.perms[i])
        c = rank_bits(bt.cbit[i], q.device)
        q = merge(q, rq, c)
        s = merge(s, rs, c)
    return q, s


def _int8_tables(algo: str, p: int) -> tb.ButterflyTables:
    if algo not in _KIND:
        raise ValueError(f"int8 wire supports bine/recdoub, not {algo!r}")
    return tb.butterfly_tables(_KIND[algo], p)


def reduce_scatter_q(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """int8-wire reduce-scatter: ``[p, n]`` -> ``[p, n/p]`` float32."""
    p = x.shape[0]
    v = x.reshape(p, -1).to(torch.float32)
    if p == 1:
        return v.reshape(x.shape)
    bt = _int8_tables(algo, p)
    if v.shape[1] % p:
        raise ValueError("reduce_scatter needs len divisible by p")
    return _rs_core_q(permute_blocks(v, bt.inv_final), bt)


def allgather_q(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """int8-wire allgather: ``[p, blk]`` -> ``[p, p*blk]`` float32, quantized
    once, moved, and decoded once (own block included)."""
    p = x.shape[0]
    v = x.reshape(p, -1).to(torch.float32)
    if p == 1:
        return v
    bt = _int8_tables(algo, p)
    q, s = _ag_core_q(*comp.quantize_wire(v), bt)
    return comp.dequantize_wire(permute_blocks(q, bt.final_block),
                                permute_blocks(s, bt.final_block))


# ---------------------------------------------------------------------------
# Dimension-general butterfly RS / AG (ZeRO-1 gradient/param sharding)
# ---------------------------------------------------------------------------
# ``dim`` is the per-rank dim, as in the reference; the stacked tensor
# carries it at ``dim + 1``.

def _halves_dim(buf: torch.Tensor, d: int, c: torch.Tensor) -> torch.Tensor:
    """Row r's half ``c[r]`` along stacked dim ``d``."""
    half = buf.shape[d] // 2
    lo = buf.narrow(d, 0, half)
    hi = buf.narrow(d, half, half)
    sel = (c == 0).view(-1, *([1] * (buf.dim() - 1)))
    return torch.where(sel, lo, hi)


def reduce_scatter_dim(x: torch.Tensor, dim: int, algo: str = "bine"):
    """Reduce over ranks; scatter blocks of per-rank dim ``dim``.  Rank r
    receives block r (the Sec. 4.3.1 permutation is applied up front)."""
    p = x.shape[0]
    if p == 1:
        return x
    if algo == "ring":
        return _ring_rs_dim(x, dim)
    bt = butterfly(algo, p)
    d = dim + 1
    if x.shape[d] % p:
        raise ValueError((tuple(x.shape), dim, p))
    blk = x.shape[d] // p
    buf = torch.cat([x.narrow(d, int(b) * blk, blk) for b in bt.inv_final],
                    dim=d)
    for i in range(bt.s):
        c = rank_bits(bt.cbit[i], x.device)
        send = _halves_dim(buf, d, 1 - c)
        buf = _halves_dim(buf, d, c) + permute(send, bt.perms[i])
    return buf


def allgather_dim(x: torch.Tensor, dim: int, algo: str = "bine"):
    """Inverse of :func:`reduce_scatter_dim`: gather blocks along ``dim``."""
    p = x.shape[0]
    if p == 1:
        return x
    if algo == "ring":
        return _ring_ag_dim(x, dim)
    bt = butterfly(algo, p)
    d = dim + 1
    blk = x.shape[d]
    buf = x
    for i in range(bt.s - 1, -1, -1):
        recv = permute(buf, bt.perms[i])
        c = rank_bits(bt.cbit[i], x.device)
        lo = torch.cat([buf, recv], dim=d)
        hi = torch.cat([recv, buf], dim=d)
        buf = torch.where((c == 0).view(-1, *([1] * (buf.dim() - 1))), lo, hi)
    return torch.cat([buf.narrow(d, int(b) * blk, blk)
                      for b in bt.final_block], dim=d)


def _ring_rs_dim(x: torch.Tensor, dim: int):
    """Ring RS along per-rank dim ``dim``: the flat ring over a dim-fronted
    view, whose p blocks are the dim's p blocks (each element sees the
    same adds in the same order as in the reference's sliced version)."""
    p = x.shape[0]
    if x.shape[dim + 1] % p:
        raise ValueError((tuple(x.shape), dim, p))
    xm = torch.movedim(x, dim + 1, 1)
    flat = _ring_reduce_scatter(xm.reshape(p, -1))
    out = flat.reshape((p, xm.shape[1] // p) + tuple(xm.shape[2:]))
    return torch.movedim(out, 1, dim + 1)


def _ring_ag_dim(x: torch.Tensor, dim: int):
    p = x.shape[0]
    xm = torch.movedim(x, dim + 1, 1)
    flat = _ring_allgather(xm.reshape(p, -1))
    out = flat.reshape((p, xm.shape[1] * p) + tuple(xm.shape[2:]))
    return torch.movedim(out, 1, dim + 1)


# ---------------------------------------------------------------------------
# Ring baselines
# ---------------------------------------------------------------------------

def ring_perm(p: int):
    return [(r, (r + 1) % p) for r in range(p)]


def ring_blocks(p: int, shift: int, device) -> torch.Tensor:
    """Every rank's ring block ``(idx - shift) % p`` as an int64 ``[p]``."""
    return _ints((np.arange(p) - shift) % p, torch.int64, device)


def _ring_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """``[p, n]`` -> ``[p, n/p]``.  Step t sends block ``(idx-t-1) % p``
    and adds the received chunk into block ``(idx-t-2) % p``: ``cur +
    recv``.  Works on one copy of ``x``, updated in place."""
    p = x.shape[0]
    v = x.reshape(p, -1)
    if v.shape[1] % p:
        raise ValueError("reduce_scatter needs len divisible by p")
    blk = v.shape[1] // p
    v = v.clone()
    perm = ring_perm(p)
    for t in range(p - 1):
        chunk = take_blocks(v, ring_blocks(p, t + 1, v.device), 1, blk)
        recv = permute(chunk, perm)
        ridx = ring_blocks(p, t + 2, v.device)
        cur = take_blocks(v, ridx, 1, blk)
        put_blocks(v, ridx, cur + recv, blk)
    return take_blocks(v, ring_blocks(p, 0, v.device), 1, blk)


def _ring_allgather(x: torch.Tensor) -> torch.Tensor:
    """``[p, blk]`` -> ``[p, p*blk]``: step t forwards block
    ``(idx-t) % p`` and lands the received one at ``(idx-t-1) % p``."""
    p = x.shape[0]
    row = x.reshape(p, -1)
    blk = row.shape[1]
    v = row.new_zeros((p, p * blk))
    put_blocks(v, ring_blocks(p, 0, v.device), row, blk)
    perm = ring_perm(p)
    for t in range(p - 1):
        chunk = take_blocks(v, ring_blocks(p, t, v.device), 1, blk)
        put_blocks(v, ring_blocks(p, t + 1, v.device), permute(chunk, perm),
                   blk)
    return v


def allreduce_ring(x: torch.Tensor) -> torch.Tensor:
    """Ring RS + ring AG of ``x [p, ...]``, zero-padded to a multiple of p
    (any rank count)."""
    p = x.shape[0]
    if p == 1:
        return x
    v, n = _pad_to(x.reshape(p, -1), p)
    full = _ring_allgather(_ring_reduce_scatter(v))
    return full[:, :n].reshape(x.shape)


# ---------------------------------------------------------------------------
# Trees: broadcast / reduce (small vectors) — paper Sec. 4.5
# ---------------------------------------------------------------------------

_TREE = {"bine": "bine_dh", "binomial": "binomial_dh",
         "binomial_dd": "binomial_dd"}


def broadcast(x: torch.Tensor, root: int = 0,
              algo: str = "bine") -> torch.Tensor:
    """Root's ``x`` on every rank: at step i the ranks whose
    ``recv_step`` is i take what they receive."""
    p = x.shape[0]
    if p == 1:
        return x
    tt = tb.tree_tables(_TREE[algo], p, root)
    buf = x
    for i in range(tt.s):
        recv = permute_partial(buf, tt.perms[i])
        buf = torch.where(rank_mask(tt.recv_step == i, buf), recv, buf)
    return buf


def reduce(x: torch.Tensor, root: int = 0, algo: str = "bine") -> torch.Tensor:
    """Tree reduce: the broadcast reversed; each rank forwards its
    accumulator to its parent once.  Row ``root`` holds the sum."""
    p = x.shape[0]
    if p == 1:
        return x
    tt = tb.tree_tables(_TREE[algo], p, root)
    s = tt.s
    acc = x
    for i in range(s):
        pairs = [(dst, src) for (src, dst) in tt.perms[s - 1 - i]]
        contrib = permute_partial(acc, pairs)
        receives = np.array([any(d == r for _, d in pairs) for r in range(p)])
        acc = acc + torch.where(rank_mask(receives, contrib), contrib,
                                torch.zeros_like(contrib))
    return acc


# ---------------------------------------------------------------------------
# Gather / Scatter (paper Sec. 4.1 / 4.2)
# ---------------------------------------------------------------------------

def _clamped(off, p: int, nblk: int) -> np.ndarray:
    """``lax.dynamic_slice`` clamps its start so the window stays inside
    the buffer; the tables' offsets of non-participating ranks rely on
    it."""
    return np.clip(np.asarray(off), 0, p - nblk)


def gather(x: torch.Tensor, root: int = 0, algo: str = "bine") -> torch.Tensor:
    """``[p, blk]`` -> ``[p, p*blk]``: the rank-ordered vector, valid at
    the root (the other rows hold what the schedule left there)."""
    p = x.shape[0]
    if p == 1:
        return x
    gt = tb.gather_tables({"bine": "bine_dh", "binomial": "binomial_dh"}[algo],
                          p, root)
    dev = x.device
    v = x.reshape(p, -1)
    blk = v.shape[1]
    buf = v.new_zeros((p, p * blk))
    put_blocks(buf, rank_rows(gt.own_local, dev), v, blk)
    for j in range(gt.s):
        nblk = gt.sizes[j]
        chunk = buf[:, :nblk * blk]      # the sender's window starts at 0
        recv = permute_partial(chunk, gt.perms[j])
        off = rank_rows(_clamped(gt.recv_off[j], p, nblk), dev)
        cur = take_blocks(buf, off, nblk, blk)
        put_blocks(buf, off, torch.where(rank_mask(gt.recv_mask[j], cur),
                                         recv, cur), blk)
    return permute_blocks(buf, gt.root_unrot)


def scatter(x: torch.Tensor, root: int = 0, algo: str = "bine") -> torch.Tensor:
    """``[p, n]`` (significant at the root) -> ``[p, n/p]``: rank r's
    block r.  ``bine`` runs the distance-halving tree."""
    p = x.shape[0]
    if p == 1:
        return x
    st = tb.scatter_tables(
        {"bine": "bine_dh", "bine_dd": "bine_dd",
         "binomial": "binomial_dh"}[algo], p, root)
    dev = x.device
    v = x.reshape(p, -1)
    if v.shape[1] % p:
        raise ValueError("scatter needs len divisible by p")
    blk = v.shape[1] // p
    buf = permute_blocks(v, st.root_rot)
    for j in range(st.s):
        nblk = st.sizes[j]
        soff = rank_rows(_clamped(st.send_off[j], p, nblk), dev)
        recv = permute_partial(take_blocks(buf, soff, nblk, blk), st.perms[j])
        cur = buf[:, :nblk * blk]
        buf[:, :nblk * blk] = torch.where(rank_mask(st.recv_mask[j], cur),
                                          recv, cur)
    return take_blocks(buf, rank_rows(st.own_local, dev), 1, blk)


# ---------------------------------------------------------------------------
# Alltoall (paper Sec. 4.4)
# ---------------------------------------------------------------------------

def all_to_all(x: torch.Tensor, algo: str = "bine") -> torch.Tensor:
    """``x [p, p, ...]`` (rank r's row d goes to rank d) -> ``[p, p, ...]``
    (rank r's row o came from rank o), by butterfly routing: p/2 slots per
    step over log2(p) steps."""
    p = x.shape[0]
    if p == 1:
        return x
    if x.shape[1] != p:
        raise ValueError("all_to_all expects the per-rank leading dim == p")
    at = tb.alltoall_tables({"bine": "bine_dd", "bruck": "bruck",
                             "recdoub": "recdoub_dd"}[algo], p)
    dev = x.device
    ar = torch.arange(p, device=dev).view(p, 1)
    buf = x.reshape(p, p, -1).clone()
    for j in range(at.s):
        chunk = buf[ar, rank_rows(at.send_slots[j], dev)]
        recv = permute(chunk, at.perms[j])
        buf[ar, rank_rows(at.recv_slots[j], dev)] = recv
    return buf[ar, rank_rows(at.final_slots, dev)].reshape(x.shape)


# ---------------------------------------------------------------------------
# Schedule-IR executor: one index gather a step, static block-id tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _schedule_tables(sched: Schedule):
    """Static per-step dispatch tables for ``run_schedule``:
    ``(kind, perm, send [p, k], recv [p, k])`` a step, as the reference's.

    Requires full-permutation steps (every rank sends once and receives
    once, all messages the same block count): true of every pow2
    butterfly, ring and composed schedule; the non-pow2 adapter schedules
    are not executable here.  Packing order is the message's ``blocks``
    tuple, so sender and receiver tables agree by construction."""
    p = sched.p
    out = []
    for step, kind in zip(sched.steps, sched.kinds):
        if len(step) != p:
            raise ValueError(
                f"run_schedule needs full-permutation steps; got "
                f"{len(step)} messages for p={p}")
        k = len(step[0].blocks)
        send = np.zeros((p, k), np.int32)
        recv = np.zeros((p, k), np.int32)
        perm = []
        for m in step:
            if len(m.blocks) != k or BLOCK_ALL in m.blocks:
                raise ValueError("uneven or whole-vector blocks in a step")
            send[m.src] = m.blocks
            recv[m.dst] = m.blocks
            perm.append((int(m.src), int(m.dst)))
        out.append((kind, tuple(perm), send, recv))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _schedule_rows(sched: Schedule):
    """Per step, ``(kind, gather, land)``: row indices into the ``[p*p,
    blk]`` view of the ``[p, p, blk]`` (rank, block) buffer.  ``gather``
    lists, for each receiving rank in turn, the rows its sender sends (the
    send gather and the ppermute in one); ``land`` the rows they land in."""
    p = sched.p
    out = []
    for kind, perm, send, recv in _schedule_tables(sched):
        src = sources(perm, p)
        gather = (src[:, None] * p + send[src]).ravel()
        land = (np.arange(p)[:, None] * p + recv).ravel()
        out.append((kind, tuple(int(i) for i in gather),
                    tuple(int(i) for i in land)))
    return tuple(out)


def run_schedule(v: torch.Tensor, sched: Schedule) -> torch.Tensor:
    """Execute a block-schedule IR value on ``v [p, p, blk]`` (rank r's
    block b at ``v[r, b]``); returns the new buffer, ``v`` is not changed.

    Each step is one index gather over the ``[p*p, blk]`` rows (every
    rank's send blocks, taken from its sender: the ppermute), landed by
    kind: ``reduce`` accumulates (``index_add_``: ``block + recv``, one
    add a block, as the reference's ``.at[].add``), ``copy``/``move``
    install (``index_copy_``).  Relinquished blocks go stale in the
    buffer; the IR's kind discipline (the numpy oracle checks it) keeps
    them from being read again."""
    p = sched.p
    if tuple(v.shape[:2]) != (p, p):
        raise ValueError(f"run_schedule needs a [p, p, blk] buffer for "
                         f"p={p}; got {tuple(v.shape)}")
    rows = v.reshape(p * p, -1).clone()
    for kind, gather, land in _schedule_rows(sched):
        got = rows.index_select(0, _ints(gather, torch.int64, rows.device))
        idx = _ints(land, torch.int64, rows.device)
        if kind == KIND_REDUCE:
            rows.index_add_(0, idx, got)
        else:
            rows.index_copy_(0, idx, got)
    return rows.view(v.shape)


def reduce_scatter_sched(x: torch.Tensor, sched: Schedule) -> torch.Tensor:
    """``x [p, n]`` -> ``[p, n/p]``: rank r's reduced block r, via an RS
    schedule value (e.g. ``core.schedules.compose("reduce_scatter",
    tiers)``)."""
    p = sched.p
    v = x.reshape(p, -1)
    if v.shape[1] % p:
        raise ValueError(f"reduce_scatter_sched needs len divisible by "
                         f"p={p}; got {v.shape[1]}")
    v = run_schedule(v.view(p, p, -1), sched)
    ar = torch.arange(p, device=v.device)
    return v[ar, ar]


def allgather_sched(x: torch.Tensor, sched: Schedule) -> torch.Tensor:
    """``x [p, blk]`` (rank r's block) -> ``[p, p*blk]``: the blocks in
    rank order on every rank, via an AG schedule value."""
    p = sched.p
    blk = x.reshape(p, -1)
    v = blk.new_zeros((p, p, blk.shape[1]))
    ar = torch.arange(p, device=v.device)
    v[ar, ar] = blk
    return run_schedule(v, sched).reshape(p, -1)


def allreduce_sched(x: torch.Tensor, sched: Schedule) -> torch.Tensor:
    """Allreduce of ``x [p, ...]`` via a composed RS+AG schedule value,
    zero-padded to a multiple of p."""
    p = sched.p
    v, n = _pad_to(x.reshape(p, -1), p)
    v = run_schedule(v.view(p, p, -1), sched)
    return v.reshape(p, -1)[:, :n].reshape(x.shape)


# ---------------------------------------------------------------------------
# Two DP axes: one axis of a row-major stacking; the hierarchy (Sec. 6.2)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def axis_groups(shape: Tuple[int, ...], axis: int) -> Tuple[Tuple[int, ...],
                                                            ...]:
    """The rank groups of axis ``axis`` of a row-major stacking of
    ``shape``: each group holds the ranks that differ only in that axis,
    in the axis's order (its rank 0 first)."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    return tuple(tuple(int(r) for r in g)
                 for g in np.moveaxis(ranks, axis, -1).reshape(
                     -1, shape[axis]))


def over_axis(fn, x: torch.Tensor, shape: Tuple[int, ...], axis: int,
              *args) -> torch.Tensor:
    """Run the stacked one-axis collective ``fn(rows, *args)`` over axis
    ``axis`` of ``x [p, ...]`` stacked row-major as ``shape``: within each
    group of :func:`axis_groups`, one group after another, so a reduction
    stays inside its group; row r of the result is rank r's."""
    shape = tuple(int(d) for d in shape)
    if x.shape[0] != int(np.prod(shape)):
        raise ValueError(f"{x.shape[0]} stacked ranks do not make the "
                         f"DP shape {shape}")
    groups = axis_groups(shape, axis)
    if len(groups) == 1:
        return fn(x, *args)
    out = None
    for g in groups:
        idx = _ints(g, torch.int64, x.device)
        y = fn(x.index_select(0, idx), *args)
        if out is None:
            out = y.new_empty((x.shape[0],) + tuple(y.shape[1:]))
        out.index_copy_(0, idx, y)
    return out


def allreduce_hier(x: torch.Tensor, shape: Tuple[int, ...],
                   axes: Sequence[int], algo: str = "bine") -> torch.Tensor:
    """Arbitrary-depth hierarchy over the axes of ``shape``, innermost
    (fastest) first: RS down the stack, each level on a 1/p shard of the
    one above, the butterfly allreduce at the top, AG back up.  The
    stacked twin of ``core.schedules.compose`` over the axes' sizes."""
    if len(axes) == 1:
        return over_axis(allreduce_butterfly, x, shape, axes[0], algo)
    inner = axes[0]
    p_in = shape[inner]
    if p_in == 1:
        return allreduce_hier(x, shape, axes[1:], algo)
    p = x.shape[0]
    v, n = _pad_to(x.reshape(p, -1), p_in)
    shard = over_axis(reduce_scatter, v, shape, inner, algo)
    shard = allreduce_hier(shard, shape, axes[1:], algo)
    full = over_axis(allgather, shard, shape, inner, algo)
    return full[:, :n].reshape(x.shape)


def allreduce_hierarchical(x: torch.Tensor, shape: Tuple[int, ...],
                           inner: int, outer: int,
                           algo: str = "bine") -> torch.Tensor:
    """RS within the (fast) inner axis, allreduce across the (slow) outer
    axis on the 1/p_in shard, AG within the inner axis: each rank's
    crossing bytes drop from O(n) to n/p_in.  The depth-2 case of
    :func:`allreduce_hier`."""
    return allreduce_hier(x, shape, (inner, outer), algo)


# ---------------------------------------------------------------------------
# The framework's own collectives over the rank dim (``backend="xla"``)
# ---------------------------------------------------------------------------
# The reference's ``xla`` backend calls XLA's built-ins; on the stacked
# executor they are PyTorch reductions and reshapes over dim 0 (a
# multi-GPU executor maps them to NCCL).  Sums run in PyTorch's order, not
# XLA's: floating-point results agree to rounding, not bitwise.

def psum(x: torch.Tensor) -> torch.Tensor:
    """``lax.psum``: the rank sum, on every rank.  Ints keep their dtype;
    bool sums to int32, as ``lax.psum`` counts it."""
    s = x.sum(0, keepdim=True,
              dtype=torch.int32 if x.dtype == torch.bool else x.dtype)
    return s.expand(x.shape).contiguous()


def psum_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``lax.psum_scatter(x, scatter_dimension=dim, tiled=True)``: the rank
    sum, rank r keeping block r of per-rank dim ``dim``."""
    p = x.shape[0]
    s = x.sum(0, dtype=x.dtype)
    if s.shape[dim] % p:
        raise ValueError((tuple(x.shape), dim, p))
    return torch.movedim(s.unflatten(dim, (p, s.shape[dim] // p)), dim, 0)


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, axis=dim, tiled=True)``: every rank gets the
    ranks' blocks concatenated along per-rank dim ``dim``."""
    p = x.shape[0]
    full = torch.cat(list(x), dim=dim)
    return full.unsqueeze(0).expand((p,) + tuple(full.shape)).contiguous()


def all_to_all_xla(x: torch.Tensor) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0)``: the rank and slot
    dims swapped."""
    return x.transpose(0, 1).contiguous()
