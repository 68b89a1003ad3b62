"""Decoder LM backbone: pattern-segmented layer stack.

Port of ``repro.models.transformer`` for dense ``attn`` blocks.  The
parameter tree keeps the reference's layout — ``segments[i]`` leaves are
stacked ``[n_layers_in_segment, ...]`` — so trees cross between the
packages leaf for leaf (``repro_torch.interop``).  Layers of a segment run
in a Python loop over the stacked leaves (the reference's ``lax.scan``).

Two paths, as in the reference: ``forward``/``loss_fn`` (training, through
autograd) keep the plain ``layers.rmsnorm`` and the query-chunked
``layers.attention``; the serving half (``prefill``, ``decode_step``) puts
every norm on the RMSNorm kernel and prefill's attention core on the
flash-attention kernel, which have no backward.  Decode attention stays
plain torch: each slot sits at its own position, which the flash kernel's
``qpos = q_start + row`` cannot express (the reference computes it outside
any Pallas kernel too).

Decode caches are updated IN PLACE (the reference returns new arrays): a
page pool holds every layer's K/V, and copying it per token would move
the whole pool each step.  ``decode_step`` returns the state it was given,
with its caches written and a new ``pos``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch import tree as T

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm as fused_rmsnorm

from . import layers as L


@dataclass(frozen=True)
class Block:
    kind: str                      # attn | moe | mamba2 | mlstm | slstm | shared_attn
    window: Optional[int] = None   # sliding-window size for attn kinds


def layer_pattern(cfg) -> List[Block]:
    """One Block per layer, in depth order."""
    n = cfg.n_layers
    if cfg.block_pattern == "xlstm":
        return [Block("slstm") if (i % 4 == 3) else Block("mlstm")
                for i in range(n)]
    if cfg.block_pattern == "zamba":
        out: List[Block] = []
        for i in range(n):
            out.append(Block("mamba2"))
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
                out.append(Block("shared_attn"))
        return out
    kind = "moe" if cfg.n_experts > 0 else "attn"
    if cfg.local_global_ratio > 0:
        k = cfg.local_global_ratio
        return [Block(kind, window=None) if (i + 1) % (k + 1) == 0
                else Block(kind, window=cfg.local_window) for i in range(n)]
    return [Block(kind, window=cfg.window) for _ in range(n)]


def segments(cfg) -> List[Tuple[Block, int]]:
    """Maximal runs of identical blocks: [(block, run_length), ...]."""
    out: List[Tuple[Block, int]] = []
    for b in layer_pattern(cfg):
        if out and out[-1][0] == b and b.kind != "shared_attn":
            out[-1] = (b, out[-1][1] + 1)
        else:
            out.append((b, 1))
    return out


def _check_dense(cfg) -> None:
    bad = sorted({b.kind for b, _ in segments(cfg) if b.kind != "attn"})
    if bad or cfg.frontend is not None:
        raise NotImplementedError(
            f"blocks {bad or [cfg.frontend]} are not ported (ROADMAP.md "
            f"queue A item 5: MoE and recurrent models); dense 'attn' only")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _param_tree(cfg, make) -> Dict[str, Any]:
    """The parameter tree, each leaf ``make(shape, init)`` with init one of
    ``("normal", std)`` or ``("zeros",)``."""
    _check_dense(cfg)
    d, nh, nkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)

    def dense(n, i, o):
        return make((n, i, o), ("normal", 1.0 / math.sqrt(i)))

    params: Dict[str, Any] = {
        "embed": make((cfg.vocab_size, d), ("normal", 0.02))}
    segs = []
    for block, n in segments(cfg):
        attn = {"wq": dense(n, d, nh * hd), "wk": dense(n, d, nkv * hd),
                "wv": dense(n, d, nkv * hd), "wo": dense(n, nh * hd, d)}
        if cfg.qk_norm:
            attn["q_norm"] = make((n, hd), ("zeros",))
            attn["k_norm"] = make((n, hd), ("zeros",))
        segs.append({
            "ln1": make((n, d), ("zeros",)),
            "attn": attn,
            "ln2": make((n, d), ("zeros",)),
            "mlp": {"wi": dense(n, d, f), "wg": dense(n, d, f),
                    "wo": dense(n, f, d)},
        })
    params["segments"] = segs
    params["final_norm"] = make((d,), ("zeros",))
    if not cfg.tie_embeddings:
        params["lm_head"] = make((d, cfg.vocab_size),
                                 ("normal", 1.0 / math.sqrt(d)))
    return params


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors: shapes and dtypes only."""
    dt = getattr(torch, cfg.dtype)
    return _param_tree(cfg, lambda shape, init: torch.empty(
        shape, dtype=dt, device="meta"))


def init_params(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters from ``seed``: the reference's distributions
    (normal weights scaled 1/sqrt(fan_in), embedding std 0.02, zero norm
    gains), drawn in float32 and cast to ``cfg.dtype``.  The draws differ
    from ``jax.random``'s; tests carry JAX's weights across instead."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(shape, init):
        if init[0] == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * init[1]).to(dt)

    return _param_tree(cfg, make)


def param_count(params) -> int:
    return sum(int(math.prod(x.shape)) for x in T.flatten(params))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(p, cfg, block: Block, x, positions):
    h = L.attention(p["attn"], cfg, L.rmsnorm(x, p["ln1"], cfg.norm_eps),
                    positions, window=block.window)
    x = x + h
    return x + L.mlp(p["mlp"], cfg, L.rmsnorm(x, p["ln2"], cfg.norm_eps))


def _layer(seg_p, l: int):
    """Layer ``l``'s parameters out of a stacked segment tree."""
    if isinstance(seg_p, dict):
        return {k: _layer(v, l) for k, v in seg_p.items()}
    return seg_p[l]


def forward(params, cfg, inputs, positions=None):
    """inputs: [B,T] int tokens.  Returns (logits [B,T,V], aux_loss)."""
    _check_dense(cfg)
    B, T = inputs.shape[:2]
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=inputs.device)
    x = _embed(params, cfg, inputs)
    for (block, n), seg_p in zip(segments(cfg), params["segments"]):
        for l in range(n):
            x = _apply_block(_layer(seg_p, l), cfg, block, x, positions)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, head)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: dict(inputs [B,T], targets [B,T], optional mask [B,T]).

    Cross entropy in fp32 with z-loss; returns (loss, metrics)."""
    logits, aux = forward(params, cfg, batch["inputs"])
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["targets"][..., None].long())[..., 0]
    nll = lse - tgt
    del logits
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(nll.shape, dtype=torch.float32, device=nll.device)
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (nll * mask).sum() / denom
    zl = cfg.z_loss * ((lse * lse) * mask).sum() / denom
    al = cfg.aux_loss_weight * aux
    loss = ce + zl + al
    metrics = {"loss": loss, "ce": ce, "z_loss": zl, "aux_loss": al,
               "tokens": denom}
    return loss, metrics


# ---------------------------------------------------------------------------
# Decode state + single-token step (serving)
# ---------------------------------------------------------------------------

def _init_block_cache(cfg, block: Block, B: int, S_len: int,
                      device) -> dict:
    if block.kind != "attn":
        raise NotImplementedError(
            f"block {block.kind!r} is not ported (ROADMAP.md queue A item "
            f"5: MoE and recurrent models); dense 'attn' only")
    dt = getattr(torch, cfg.cache_dtype)
    W = S_len if block.window is None else min(block.window, S_len)
    shape = (B, W, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_decode_state(cfg, B: int, S_len: int, device="cuda") -> dict:
    """Per-segment stacked caches mirroring ``params['segments']``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    segs = []
    for block, n in segments(cfg):
        one = _init_block_cache(cfg, block, B, S_len, dev)
        segs.append({k: x.expand(n, *x.shape).clone()
                     for k, x in one.items()})
    return {"segments": segs,
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _decode_attn(p, cfg, block: Block, x, cache, pos):
    """One-token windowed/full attention against a (possibly ring) cache,
    written in place.

    ``pos`` is a 0-dim tensor (legacy fixed-batch decode: every sequence
    at one position) or a ``[B]`` vector (continuous-batching pool: each
    slot at its own position).  A slot whose position ran past its page
    drops its write (the reference's ``mode="drop"``); the scalar path
    clamps the slot into the cache, as ``lax.dynamic_update_slice`` does.
    """
    W = cache["k"].shape[1]
    B = x.shape[0]
    ring = block.window is not None and block.window <= W
    per_slot = pos.dim() > 0
    slot = torch.remainder(pos, W) if ring else pos
    if per_slot:
        positions = pos[:, None].to(torch.int32)             # [B,1]
    else:
        positions = pos.to(torch.int32).reshape(1)
    q, k, v = L._qkv(p["attn"], cfg,
                     fused_rmsnorm(x, p["ln1"], cfg.norm_eps), positions)
    ck, cv = cache["k"], cache["v"]
    if per_slot:
        rows = torch.arange(B, device=x.device)
        ok = (slot < W)[:, None, None]
        sc = torch.clamp(slot, max=W - 1).long()
        for c, new in ((ck, k), (cv, v)):
            c[rows, sc] = torch.where(ok, new[:, 0].to(c.dtype), c[rows, sc])
    else:
        sc = torch.clamp(slot, 0, W - 1).long().reshape(1)
        ck.index_copy_(1, sc, k.to(ck.dtype))
        cv.index_copy_(1, sc, v.to(cv.dtype))
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = nh // nkv
    qg = q.reshape(B, 1, nkv, g, hd)
    s = torch.einsum("btkgh,bskh->bkgs", qg.to(torch.float32),
                     ck.to(torch.float32)) / math.sqrt(hd)
    # cache slot s holds absolute position: s (no window) or ring-decoded
    kpos = torch.arange(W, device=x.device)
    kpos = kpos[None, :] if per_slot else kpos
    posb = pos[:, None] if per_slot else pos
    slotb = slot[:, None] if per_slot else slot
    if ring:
        # ring slots hold positions pos-W+1..pos; valid if <= pos and fresh
        age = torch.remainder(slotb - kpos, W)
        abs_pos = posb - age
        valid = (abs_pos >= 0) & (abs_pos <= posb) & (
            posb - abs_pos < block.window)
    else:
        valid = kpos <= posb
        if block.window is not None:
            valid &= (posb - kpos) < block.window
    vmask = valid[:, None, None, :] if per_slot else valid[None, None, None, :]
    s = torch.where(vmask, s, torch.full((), -math.inf, device=x.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, cv.to(torch.float32))
    o = o.reshape(B, 1, nh * hd).to(x.dtype)
    return L.dense(o, p["attn"]["wo"]), cache


def _decode_block(p, cfg, block: Block, x, cache, pos):
    h, cache = _decode_attn(p, cfg, block, x, cache, pos)
    x = x + h
    return x + L.mlp(p["mlp"], cfg,
                     fused_rmsnorm(x, p["ln2"], cfg.norm_eps)), cache


def _logits(params, cfg, x):
    x = fused_rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head)


def _embed(params, cfg, tokens):
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def decode_step(params, cfg, state, tokens, active=None):
    """tokens: [B,1] int.  One decode step, caches written in place.

    ``state["pos"]`` may be a 0-dim tensor (legacy fixed batch) or a
    ``[B]`` vector (continuous-batching slot pool; see ``serve.kvcache``).
    With an ``active`` mask (``[B]`` in {0,1}) only active slots advance
    their position — retired slots stay frozen until ``insert`` recycles
    them.

    Returns (logits [B,1,V], state)."""
    _check_dense(cfg)
    pos = state["pos"]
    x = _embed(params, cfg, tokens)
    for (block, n), seg_p, seg_c in zip(
            segments(cfg), params["segments"], state["segments"]):
        for l in range(n):
            x, _ = _decode_block(_layer(seg_p, l), cfg, block, x,
                                 _layer(seg_c, l), pos)
    logits = _logits(params, cfg, x)
    adv = 1 if active is None else torch.as_tensor(
        active, device=pos.device).to(torch.int32)
    return logits, {"segments": state["segments"], "pos": pos + adv}


def prefill(params, cfg, inputs, length=None):
    """Full-sequence forward that also fills a decode state.

    Returns (last-token logits [B,1,V], state).  ``length`` (an int or
    0-dim int tensor, optional) marks the number of real tokens when
    ``inputs`` is right-padded to a fixed shape (the continuous-batching
    insert path): causality keeps positions ``< length`` unaffected by the
    padding, the logits are taken at position ``length - 1``, the decode
    position starts at ``length``, and windowed ring caches are laid out
    from the real tail so slot ``q % W`` holds position ``q``.  Padded K/V
    beyond ``length`` stays in full caches but is masked by ``kpos <= pos``
    until decode overwrites it in place.
    """
    _check_dense(cfg)
    B, T = inputs.shape[:2]
    dev = inputs.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)
    if length is not None:
        length = torch.as_tensor(length, device=dev).to(torch.int32)
    x = _embed(params, cfg, inputs)
    segs = []
    for (block, n), seg_p in zip(segments(cfg), params["segments"]):
        caches = []
        for l in range(n):
            x, c = _prefill_block(_layer(seg_p, l), cfg, block, x, positions,
                                  length)
            caches.append(c)
        segs.append({k: torch.stack([c[k] for c in caches])
                     for k in caches[0]})
    if length is None:
        xl = x[:, -1:]
        pos_out = torch.tensor(T, dtype=torch.int32, device=dev)
    else:
        last = torch.clamp(length - 1, 0, T - 1).long().reshape(1)
        xl = x.index_select(1, last)
        pos_out = length.reshape(())
    return _logits(params, cfg, xl), {"segments": segs, "pos": pos_out}


def _prefill_block(p, cfg, block: Block, x, positions, length=None):
    """Forward one block over the full sequence, returning its decode
    cache.  Q, K and V are computed once, for the attention and the cache
    both (the reference computes them twice, to the same values)."""
    T = x.shape[1]
    B = x.shape[0]
    nh, hd = cfg.n_heads, cfg.head_dim
    q, k, v = L._qkv(p["attn"], cfg,
                     fused_rmsnorm(x, p["ln1"], cfg.norm_eps), positions)
    o = flash_attention(q, k, v, window=block.window, causal=True)
    x = x + L.dense(o.reshape(B, T, nh * hd).to(x.dtype), p["attn"]["wo"])
    x = x + L.mlp(p["mlp"], cfg, fused_rmsnorm(x, p["ln2"], cfg.norm_eps))
    dt = getattr(torch, cfg.cache_dtype)
    if block.window is not None and block.window < T:
        W = block.window
        if length is None:
            # ring layout: the tail, rolled so slot t % W holds position t
            roll = (T - W) % W
            ck = torch.roll(k[:, T - W:], shifts=roll, dims=1).to(dt)
            cv = torch.roll(v[:, T - W:], shifts=roll, dims=1).to(dt)
        else:
            # dynamic-length ring: slot s holds the newest real position
            # congruent to s mod W, q(s) = (L-1) - ((L-1-s) mod W); slots
            # with q(s) < 0 (short prompts) stay zero
            s_idx = torch.arange(W, device=x.device)
            last = length - 1
            q_idx = last - torch.remainder(last - s_idx, W)
            ok = (q_idx >= 0)[None, :, None, None]
            qc = torch.clamp(q_idx, 0, T - 1).long()
            zero = torch.zeros((), dtype=k.dtype, device=x.device)
            ck = torch.where(ok, k.index_select(1, qc), zero).to(dt)
            cv = torch.where(ok, v.index_select(1, qc), zero).to(dt)
    else:
        ck, cv = k.to(dt), v.to(dt)
    return x, {"k": ck, "v": cv}
