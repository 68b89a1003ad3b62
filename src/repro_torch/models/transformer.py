"""Decoder LM backbone: pattern-segmented layer stack.

Port of ``repro.models.transformer`` for dense ``attn`` blocks.  The
parameter tree keeps the reference's layout — ``segments[i]`` leaves are
stacked ``[n_layers_in_segment, ...]`` — so trees cross between the
packages leaf for leaf (``repro_torch.interop``).  Layers of a segment run
in a Python loop over the stacked leaves (the reference's ``lax.scan``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch import tree as T

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
    x = params["embed"][inputs.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
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
