"""Core layers: RMSNorm, RoPE, GQA attention (query-chunked), SwiGLU MLP.

Port of ``repro.models.layers`` for the ``single`` strategy (no tensor
parallelism).  Plain functions over dicts of tensors, mirroring the JAX
math op for op so float32 results agree within rounding.  Attention is
the reference's query-chunked online softmax written with plain torch
ops; a later slice replaces it with the flash-attention kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def rmsnorm(x, w, eps: float = 1e-6):
    dt = x.dtype
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.to(torch.float32))).to(dt)


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device):
    """Made once per device, so a forward issues no host-to-device copy."""
    return torch.as_tensor(
        (theta ** (-np.arange(0, half) / half)).astype(np.float32),
        device=device)


def rope(x, positions, theta: float):
    """x: [..., T, H, hd]; positions: [..., T]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # [..., T, half]
    cos = torch.cos(ang)[..., :, None, :]                     # [..., T, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


def dense(x, w):
    return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _qkv(p, cfg, x, positions):
    B, T, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(x, p["wq"]).reshape(B, T, nh, hd)
    k = dense(x, p["wk"]).reshape(B, T, nkv, hd)
    v = dense(x, p["wv"]).reshape(B, T, nkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _sdpa_chunk(q, k, v, qpos, kpos, window, scale):
    """One (query-chunk × kv-slice) tile, f32.  q: [B,Tq,nh,hd], k/v:
    [B,Tk,nkv,hd].  Returns the partial-softmax triple (out, row max,
    row sum) with out [B,nkv,Tq,g,hd]."""
    B, Tq, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, Tq, nkv, g, hd)
    s = torch.einsum("btkgh,bskh->bktgs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale       # [B,nkv,Tq,g,Tk]
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask[None, None, :, None, :], s,
                    torch.full((), -math.inf, device=s.device))
    m = torch.amax(s, dim=-1)                            # [B,nkv,Tq,g]
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m_safe[..., None])
    e = torch.where(torch.isfinite(s), e, torch.zeros_like(e))
    denom = torch.sum(e, dim=-1)
    o = torch.einsum("bktgs,bskh->bktgh", e, v.to(torch.float32))
    return o, m_safe, denom


def attention(p, cfg, x, positions, window=None):
    """Causal (optionally windowed) GQA over full sequences: the
    reference's ``single`` strategy — query chunks of ``attn_chunk`` and,
    for full causal attention, the lower-triangular (q-chunk, kv-chunk)
    tile walk with an online softmax."""
    B, T, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = nh // nkv
    q, k, v = _qkv(p, cfg, x, positions)
    scale = 1.0 / math.sqrt(hd)
    C = min(cfg.attn_chunk, T)
    nC = T // C
    if T % C:
        raise ValueError(f"sequence {T} is not a multiple of attn_chunk {C}")
    kpos_all = torch.arange(T, dtype=positions.dtype, device=x.device)

    outs = []
    if window is not None and window < T:
        W = min(((window + C - 1) // C) * C + C, T)
        for i in range(nC):
            qs = i * C
            ks_ = max(qs + C - W, 0)
            o, _, dn = _sdpa_chunk(q[:, qs:qs + C], k[:, ks_:ks_ + W],
                                   v[:, ks_:ks_ + W], positions[qs:qs + C],
                                   kpos_all[ks_:ks_ + W], window, scale)
            outs.append(o / torch.clamp(dn[..., None], min=1e-30))
    else:
        for i in range(nC):
            qs = i * C
            o_a = torch.zeros((B, nkv, C, g, hd), device=x.device)
            m_a = torch.full((B, nkv, C, g), -math.inf, device=x.device)
            d_a = torch.zeros((B, nkv, C, g), device=x.device)
            for j in range(i + 1):
                ks_ = j * C
                o, m, dn = _sdpa_chunk(q[:, qs:qs + C], k[:, ks_:ks_ + C],
                                       v[:, ks_:ks_ + C], positions[qs:qs + C],
                                       kpos_all[ks_:ks_ + C], None, scale)
                m_new = torch.maximum(m_a, m)
                r_a = torch.exp(torch.clamp(m_a - m_new, min=-80.0))
                r_b = torch.exp(torch.clamp(m - m_new, min=-80.0))
                o_a = o_a * r_a[..., None] + o * r_b[..., None]
                d_a = d_a * r_a + dn * r_b
                m_a = m_new
            outs.append(o_a / torch.clamp(d_a[..., None], min=1e-30))
    out = torch.stack(outs, 0)                        # [nC,B,nkv,C,g,hd]
    out = out.permute(1, 0, 3, 2, 4, 5).reshape(B, T, nh * hd)
    return dense(out.to(x.dtype), p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(p, cfg, x):
    h = dense(x, p["wi"])
    gate = dense(x, p["wg"])
    if cfg.act == "geglu":
        h = F.gelu(gate, approximate="tanh") * h
    else:  # swiglu
        h = F.silu(gate) * h
    return dense(h, p["wo"])
