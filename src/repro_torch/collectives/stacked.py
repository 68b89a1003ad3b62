"""Stacked-rank executor of the Bine butterfly collectives.

Counterpart of ``repro.collectives.shmap``.  The JAX package runs p ranks
as p devices under ``shard_map``; here they run stacked on one device:

  * every per-rank buffer is ``[p, ...]`` (row r = rank r);
  * ``lax.ppermute(x, perm)`` becomes an index gather over dim 0,
    ``out[dst] = x[src]`` (:func:`permute`);
  * each per-rank table entry, such as ``cbit[i][idx]``, becomes an int32
    ``[p]`` tensor on the buffer's device.

The schedules, the operand order (``kept + recv``) and the quantize points
are the reference's, so every result is bitwise equal to it.  This module
is the plain executor; ``kernels.collectives.ops`` runs the same
schedules with every step's local work in one CUDA kernel launch.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.collectives import compression as comp
from repro_torch.core import tables as tb

_KIND = {"bine": "bine_dd", "recdoub": "recdoub_dd"}


def butterfly(algo: str, p: int) -> tb.ButterflyTables:
    if algo not in _KIND:
        raise NotImplementedError(
            f"algo {algo!r} is not ported (ROADMAP.md queue A item 2: the "
            f"ring family comes with kernel 4); ported: {sorted(_KIND)}")
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
