"""Mixture-of-Experts: top-k router, capacity dispatch, two execution paths.

Port of ``repro.models.moe``.  Weights are stored in *expert-block*
layout: ``E * ep_blocks`` stacked units of ``d_ff / ep_blocks`` columns
each (``[EB, d, ffb]``), so the unit count divides the model axis for
every MoE arch (mixtral: 8 experts x 2 blocks = 16; phi3.5: 16 x 1) and
the stack dim shards cleanly over the TP ranks.

Paths, as in the reference (whose products are einsums outside any
Pallas kernel, so plain ``torch.bmm`` here too):

  * :func:`_moe_dense` — one rank, or the fallback: the stable capacity
    dispatch of each (token, choice) to its expert's slots, a batched
    expert product, the gate-weighted combine;
  * :func:`_moe_ep` — expert parallelism over the stacked TP ranks
    ``[n, ...]``: tokens stay sequence-sharded, each rank routes its own,
    capacity is slotted per (source, destination) rank, and the dispatch
    and combine are the collectives API's ``all_to_all`` (the obs hook
    records each call), the algorithm picked by :func:`a2a_backend`.

The backend.  :func:`a2a_backend` asks the port's decision table
(``topology.select_backend("alltoall", n, bytes, "tpu_multipod")``), as
the reference does at its pinned jax (< 0.8); its packaged tables name
``bine``, the paper's butterfly, at every payload.  Under jax >= 0.8 the
reference pins ``"xla"`` instead (``compat.NESTED_AXIS_INDEX_OK``: its
log butterflies need ``lax.axis_index`` inside a nested manual region).
An all_to_all only moves data, so every backend gives the same bits.

Determinism.  The reference gathers tokens with repeats and scatter-adds
the combine (``out.at[stok].add``); their backward and forward sum in
whatever order the device's atomics take, which would break the train
step's bitwise contracts.  Here every index step moves each value at
most once: a token is expanded to its ``K`` (``K * nb`` under EP) items
by ``expand`` (whose backward is a sum over that dim), the items are
placed into slots by a gather with unique sources (an empty slot reads
zeros), and each token's partials come back by a gather of its items'
slots and a sum over the reshaped item dim, in a fixed order.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.collectives import api, stacked

from . import sharding as SH

#: decision-table preset of the dispatch/combine all_to_all (the
#: reference's constant; paper Sec. 4.4/5.1.2: log algorithms win small
#: payloads, linear ones large)
A2A_TOPOLOGY = "tpu_multipod"


def a2a_backend(n: int, buffer_bytes: int, topology: Optional[str] = None
                ) -> str:
    """The all_to_all algorithm of the EP dispatch and combine: the
    decision table's pick for ``n`` ranks and ``buffer_bytes``, one rank's
    whole buffer (all ``n`` destination blocks)."""
    from repro_torch.topology import select_backend
    return select_backend("alltoall", n, buffer_bytes,
                          topology or A2A_TOPOLOGY)


def init_moe(cfg, make: Callable, lead: Tuple[int, ...] = ()
             ) -> Dict[str, object]:
    """One MoE sublayer's leaves, each ``make(lead + shape, init)`` (the
    ``init`` convention of ``transformer._param_tree``): the router
    ``[d, E]`` and the expert blocks ``wi``/``wg`` ``[EB, d, ffb]``,
    ``wo`` ``[EB, ffb, d]``, with the reference's scales (``wo`` by
    ``1/sqrt(d_ff)``, the whole expert's width)."""
    d, f, e, nb = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.ep_blocks
    eb, ffb = e * nb, f // nb
    s_in = ("normal", 1.0 / math.sqrt(d))
    return {"router": make(lead + (d, e), s_in),
            "wi": make(lead + (eb, d, ffb), s_in),
            "wg": make(lead + (eb, d, ffb), s_in),
            "wo": make(lead + (eb, ffb, d), ("normal", 1.0 / math.sqrt(f)))}


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the ``k`` largest, descending,
    exact ties to the lower index (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_w, cfg, xt):
    """``xt [..., N, d]`` -> (gate_vals ``[..., N, K]``, gate_idx
    ``[..., N, K]``, aux ``[...]``): the router in the param dtype, a
    float32 softmax, top-k renormalised, and the load-balance aux
    ``E * sum(mean one_hot(top1) * mean probs)``."""
    E, K = cfg.n_experts, cfg.top_k
    logits = torch.matmul(xt, router_w).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(gate_idx[..., 0], E).to(torch.float32)
    aux = E * (onehot.mean(dim=-2) * probs.mean(dim=-2)).sum(dim=-1)
    return gate_vals, gate_idx, aux


def _slots(dest: torch.Tensor, n_dest: int, cap: int):
    """Capacity slotting of items ``dest [..., M]`` (each item's
    destination) into ``n_dest * cap`` slots, in item order within a
    destination (the reference's stable argsort): returns each item's
    slot ``[..., M]`` (the trash slot ``n_dest * cap`` when dropped), its
    keep mask, and each slot's item ``[..., n_dest * cap]`` (``M`` when
    empty)."""
    M = dest.shape[-1]
    oh = F.one_hot(dest, n_dest)
    pos = (oh.cumsum(dim=-2) * oh).sum(dim=-1) - 1
    keep = pos < cap
    slot = torch.where(keep, dest * cap + pos, n_dest * cap)
    src = torch.full(dest.shape[:-1] + (n_dest * cap + 1,), M,
                     dtype=torch.int64, device=dest.device)
    # unique slots but the trash one, which is cut off
    src.scatter_(-1, slot, torch.arange(M, device=dest.device).expand_as(
        slot).contiguous())
    return slot, keep, src[..., :n_dest * cap]


def _take(v: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor
          ) -> torch.Tensor:
    """Rows ``idx [..., S]`` of ``v [..., M, d]``, zeros where ``ok`` is
    false.  The rows taken where ``ok`` holds are distinct, so the
    backward adds at most one non-zero term to each row of ``v``."""
    M, d = v.shape[-2], v.shape[-1]
    i = torch.clamp(idx, max=M - 1)[..., None].expand(
        tuple(idx.shape) + (d,))
    return torch.where(ok[..., None], torch.gather(v, -2, i),
                       v.new_zeros(()))


#: the layer's phases, each a ``torch.profiler`` range (``launch/
#: profile_step.py`` splits the MoE layer's device time by them)
PHASES = ("moe.route", "moe.dispatch", "moe.all_to_all", "moe.experts",
          "moe.combine")


def _act(cfg, g):
    if cfg.act == "swiglu":
        return F.silu(g)
    return F.gelu(g, approximate="tanh")


def use_ep(cfg, n: int, T: int) -> bool:
    """The reference's dispatch choice: expert parallelism over ``n`` TP
    ranks when the expert blocks and the sequence ``T`` both divide."""
    EB = cfg.n_experts * cfg.ep_blocks
    return n > 1 and EB % n == 0 and T % n == 0


def moe(p, cfg, x, n: int = 1, sp: bool = True
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, T, d]`` -> ``(out [B, T, d], aux)`` on one rank.

    Over ``n > 1`` stacked TP ranks ``x`` is the residual stream as the
    TP forward holds it: sequence-sharded ``[n, B, T/n, d]`` (``sp``), or
    whole on every rank ``[n, B, T, d]`` (T does not divide n).
    :func:`_moe_ep` runs where :func:`use_ep` allows; else every rank
    runs the dense path on the whole stream (gathered first, its own
    sequence shard kept after) with the whole expert blocks (``p``'s
    leaves ``[n, EB, ...]``), as the reference runs ``_moe_dense`` on the
    global stream.  Out stacked as ``x``, ``aux [n]``."""
    if n == 1:
        return _moe_dense(p, cfg, x)
    if sp and use_ep(cfg, n, x.shape[2] * n):
        return _moe_ep(p, cfg, x)
    xs = SH.seq_gather(x) if sp else x
    outs, auxs = zip(*(_moe_dense({k: v[t] for k, v in p.items()}, cfg,
                                  xs[t]) for t in range(n)))
    out = torch.stack(outs)
    return (SH.rank_block(out, 1) if sp else out), torch.stack(auxs)


# ---------------------------------------------------------------------------
# Dense (single-rank oracle) path
# ---------------------------------------------------------------------------

def _moe_dense(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, d = x.shape
    E, K, nb = cfg.n_experts, cfg.top_k, cfg.ep_blocks
    N = B * T
    xt = x.reshape(N, d)
    with record_function("moe.route"):
        gate_vals, gate_idx, aux = _route(p["router"], cfg, xt)

    cap = max(int(math.ceil(N * K / E * cfg.capacity_factor)), 1)
    with record_function("moe.dispatch"):
        slot, keep, src = _slots(gate_idx.reshape(-1), E, cap)
        items = xt[:, None].expand(N, K, d).reshape(N * K, d)
        xe = _take(items, src, src < N * K).reshape(E, cap, d)

    # expert FFN over blocks: wi/wg are [E*nb, d, ffb]; wo [E*nb, ffb, d]
    with record_function("moe.experts"):
        xeb = xe[:, None].expand(E, nb, cap, d).reshape(E * nb, cap, d)
        h = torch.bmm(xeb, p["wi"])
        g = torch.bmm(xeb, p["wg"])
        h = _act(cfg, g) * h
        yb = torch.bmm(h, p["wo"])                            # block partials
        ye = yb.reshape(E, nb, cap, d).sum(dim=1).reshape(E * cap, d)

    with record_function("moe.combine"):
        vals = _take(ye, slot, keep) * gate_vals.reshape(-1, 1).to(ye.dtype)
        out = vals.reshape(N, K, d).sum(dim=1)
    return out.reshape(B, T, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Expert-parallel path over the stacked TP ranks
# ---------------------------------------------------------------------------

def _moe_ep(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [n, B, T/n, d]``: rank t's sequence shard.  ``p``'s router is
    ``[n, d, E]`` (every rank's copy), its expert blocks ``[n, Lb, ...]``
    (rank t's ``Lb = EB / n`` blocks) or ``[n, EB, ...]`` held whole on
    every rank (pure_sp), of which rank t takes its own, as the
    reference's shard_map slices a replicated leaf.  Returns the output
    stacked as ``x`` and the ranks' mean aux ``[n]``."""
    n, B, Tl, d = x.shape
    E, K, nb = cfg.n_experts, cfg.top_k, cfg.ep_blocks
    Lb = E * nb // n                # expert blocks per rank
    Nl = B * Tl                     # local tokens per rank
    M = Nl * K * nb                 # (token, choice, block) items per rank
    # capacity per (source rank, destination rank): balanced-expert
    # expectation x cf headroom, static so the payload is fixed-size
    cap = max(int(math.ceil(Nl * K * nb / n * cfg.capacity_factor)), 4)
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)
                           ).element_size()
    ccfg = api.CollectiveConfig(backend=a2a_backend(n, n * cap * d *
                                                    itemsize))
    wi, wg, wo = (w if w.shape[1] == Lb else SH.rank_block(w, 0)
                  for w in (p["wi"], p["wg"], p["wo"]))

    xt = x.reshape(n, Nl, d)
    with record_function("moe.route"):
        gate_vals, gate_idx, aux = _route(p["router"], cfg, xt)
        aux = stacked.psum(aux) / n                           # pmean

    # the destination rank of each (token, choice, block) item
    with record_function("moe.dispatch"):
        blocks = (gate_idx[..., None] * nb +
                  torch.arange(nb, device=x.device)).reshape(n, M)
        slot, keep, src = _slots(blocks // Lb, n, cap)
        items = xt[:, :, None].expand(n, Nl, K * nb, d).reshape(n, M, d)
        full = src < M
        send = _take(items, src, full).reshape(n, n, cap, d)
        send_blk = torch.where(full, torch.gather(blocks, -1, torch.clamp(
            src, max=M - 1)), -1).to(torch.int32).reshape(n, n, cap)

    with record_function("moe.all_to_all"):
        recv = api.all_to_all(send, ccfg)
        recv_blk = api.all_to_all(send_blk, ccfg)

    # ---- local expert blocks: one masked product each, float32 sum ----
    with record_function("moe.experts"):
        xin = recv.reshape(n, n * cap, d)
        lb = recv_blk.reshape(n, n * cap).long() - (
            torch.arange(n, device=x.device) * Lb)[:, None]
        valid = (lb >= 0) & (lb < Lb)
        lb_c = torch.clamp(lb, 0, Lb - 1)
        y = torch.zeros((n, n * cap, d), dtype=torch.float32,
                        device=x.device)
        for b in range(Lb):
            m = (lb_c == b) & valid
            xb = torch.where(m[..., None], xin, xin.new_zeros(()))
            h = torch.bmm(xb, wi[:, b])
            g = torch.bmm(xb, wg[:, b])
            h = _act(cfg, g) * h
            y = y + torch.bmm(h, wo[:, b]).to(torch.float32)
        y = y.reshape(n, n, cap, d).to(x.dtype)

    with record_function("moe.all_to_all"):    # the combine, reversed
        back = api.all_to_all(y, ccfg).reshape(n, n * cap, d)

    # each item's partial from its slot, gate-weighted, summed per token
    with record_function("moe.combine"):
        gv = gate_vals[..., None].expand(n, Nl, K, nb).reshape(n, M, 1)
        part = _take(back, slot, keep) * gv.to(back.dtype)
        out = part.reshape(n, Nl, K * nb, d).sum(dim=2)
    return out.reshape(n, B, Tl, d).to(x.dtype), aux

