"""Core layers: RMSNorm, RoPE, GQA attention (query-chunked), SwiGLU MLP.

Port of ``repro.models.layers``.  Plain functions over dicts of tensors,
mirroring the JAX math op for op so float32 results agree within
rounding.  Attention is the reference's query-chunked online softmax
written with plain torch ops, in its three strategies: ``attention`` (the
``single`` path), ``_attn_head_parallel`` (``megatron_sp``: each TP rank's
heads, exact-causal triangular tiles) and ``_attn_seq_parallel``
(``pure_sp``: each TP rank's query chunks, vectorized over chunks).  The
TP ranks run stacked (``models.transformer``); ``dense_tp`` is one
plain matmul per rank on its weight shard.
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


def _promote(x, w):
    """``x`` and ``w`` in one dtype, as ``jnp.einsum`` promotes them: a
    frontend model's float32 frames times its bf16 weights run in float32
    (autograd casts the weight's gradient back to bf16, as JAX's
    transpose of the convert does).  Operands of one dtype pass as
    they are."""
    if x.dtype == w.dtype:
        return x, w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def dense(x, w):
    return torch.matmul(*_promote(x, w))


def dense_tp(x, w):
    """Stacked TP ranks: ``x [n, ..., d_in]`` times each rank's own
    ``w [n, d_in, d_out]``, one matmul per rank (a column- or
    row-parallel product on the rank's shard), promoted as ``dense``."""
    n = x.shape[0]
    x, w = _promote(x, w)
    y = torch.bmm(x.reshape(n, -1, x.shape[-1]), w)
    return y.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


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


def _masked_tile(s, mask):
    """The reference's tile softmax pieces: ``s`` masked to -inf, its
    finite row max, the exponentials and their row sum."""
    s = torch.where(mask, s, torch.full((), -math.inf, device=s.device))
    m = torch.amax(s, dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]),
                    torch.zeros((), device=s.device))
    return e, m_safe, e.sum(dim=-1)


def _attn_head_parallel(q, k, v, positions, window, scale, C):
    """megatron_sp attention over one TP rank's heads: ``q``, ``k``, ``v``
    ``[B, T, h, hd]`` (K/V already repeated to the query heads), the
    exact-causal triangular (q-chunk, kv-chunk) tile walk, or for a window
    shorter than T one static KV slice per query chunk.  The stacked TP
    ranks ride in ``B``.  Returns ``[B, T, h, hd]`` float32."""
    B, T, nh, hd = q.shape
    nC = T // C
    kpos_all = torch.arange(T, dtype=positions.dtype, device=q.device)

    def tile(qs, ks_, W):
        qp, kp = positions[qs:qs + C], kpos_all[ks_:ks_ + W]
        s = torch.einsum("bqnh,bknh->bnqk",
                         q[:, qs:qs + C].to(torch.float32),
                         k[:, ks_:ks_ + W].to(torch.float32)) * scale
        mask = kp[None, :] <= qp[:, None]
        if window is not None:
            mask &= (qp[:, None] - kp[None, :]) < window
        e, m, dn = _masked_tile(s, mask[None, None])
        o = torch.einsum("bnqk,bknh->bnqh", e,
                         v[:, ks_:ks_ + W].to(torch.float32))
        return o, m, dn                       # [B,nh,C,hd], [B,nh,C]

    outs = []
    if window is not None and window < T:
        W = min(((window + C - 1) // C) * C + C, T)
        for i in range(nC):
            o, _, dn = tile(i * C, max(i * C + C - W, 0), W)
            outs.append(o / torch.clamp(dn[..., None], min=1e-30))
    else:
        for i in range(nC):
            for j in range(i + 1):
                o, m, dn = tile(i * C, j * C, C)
                if j == 0:
                    o_a = torch.zeros_like(o)
                    m_a = torch.full_like(m, -math.inf)
                    d_a = torch.zeros_like(dn)
                m_new = torch.maximum(m_a, m)
                r_a = torch.exp(torch.clamp(m_a - m_new, min=-80.0))
                r_b = torch.exp(torch.clamp(m - m_new, min=-80.0))
                o_a = o_a * r_a[..., None] + o * r_b[..., None]
                d_a = d_a * r_a + dn * r_b
                m_a = m_new
            outs.append(o_a / torch.clamp(d_a[..., None], min=1e-30))
    out = torch.stack(outs, 0)                          # [nC,B,nh,C,hd]
    return out.permute(1, 0, 3, 2, 4).reshape(B, T, nh, hd)


def _attn_seq_parallel(q, k, v, qpos, window, scale, C):
    """pure_sp attention, the TP ranks stacked: rank t's query chunks
    ``q [n, B, Tl, nh, hd]`` at positions ``qpos [n, Tl]`` against every
    key, ``k``/``v [n, B, T, nkv, hd]`` (each rank's gathered copy),
    vectorized over chunks of ``C``: for a window with ``window + C < T``
    the static KV band ending at each chunk, else every KV chunk in turn
    with an online softmax (block-masked tiles: the full T^2 work, as in
    the reference).  Returns ``[n, B, Tl, nh, hd]`` float32."""
    n, B, Tl, nh, hd = q.shape
    T, nkv = k.shape[2], k.shape[3]
    g = nh // nkv
    nCl = Tl // C
    qg = q.reshape(n, B, nCl, C, nkv, g, hd).to(torch.float32)
    qp = qpos.reshape(n, nCl, C)
    ninf = torch.full((), -math.inf, device=q.device)

    if window is not None and window + C < T:
        Wb = min(((window + C - 1) // C) * C + C, T)
        starts = np.clip(np.arange(T // C) * C + C - Wb, 0, T - Wb)
        starts = starts.reshape(n, nCl)
        idx = torch.as_tensor(starts[..., None] + np.arange(Wb),
                              device=q.device)            # [n, nCl, Wb]

        def band(x):             # [n,B,nCl,Wb,nkv,hd]: static slices
            return torch.stack([torch.stack(
                [x[t, :, a:a + Wb] for a in starts[t].tolist()], 1)
                for t in range(n)])

        kband, vband = band(k), band(v)
        kp = idx.to(qpos.dtype)                           # [n, nCl, Wb]
        s = torch.einsum("tbicngh,tbijnh->tbincgj", qg,
                         kband.to(torch.float32)) * scale
        mask = (kp[:, :, None, :] <= qp[:, :, :, None]) & \
            (qp[:, :, :, None] - kp[:, :, None, :] < window)  # [n,nCl,C,Wb]
        e, _, dn = _masked_tile(s, mask[:, None, :, None, :, None, :])
        o = torch.einsum("tbincgj,tbijnh->tbincgh", e,
                         vband.to(torch.float32))
        out = o / torch.clamp(dn, min=1e-30)[..., None]
    else:
        o_a = torch.zeros((n, B, nCl, nkv, C, g, hd), device=q.device)
        m_a = torch.full((n, B, nCl, nkv, C, g), -math.inf, device=q.device)
        d_a = torch.zeros((n, B, nCl, nkv, C, g), device=q.device)
        for j in range(T // C):
            kp = torch.arange(j * C, j * C + C, dtype=qpos.dtype,
                              device=q.device)
            s = torch.einsum("tbicngh,tbjnh->tbincgj", qg,
                             k[:, :, j * C:j * C + C].to(torch.float32)) * scale
            mask = kp <= qp[..., None]                    # [n,nCl,C,Ck]
            if window is not None:
                mask &= (qp[..., None] - kp) < window
            s = torch.where(mask[:, None, :, None, :, None, :], s, ninf)
            m = torch.amax(s, dim=-1)
            m_new = torch.maximum(m_a, m)
            m_sub = torch.where(torch.isfinite(m_new), m_new,
                                torch.zeros_like(m_new))
            e = torch.where(torch.isfinite(s), torch.exp(s - m_sub[..., None]),
                            torch.zeros((), device=q.device))
            o = torch.einsum("tbincgj,tbjnh->tbincgh", e,
                             v[:, :, j * C:j * C + C].to(torch.float32))
            r = torch.exp(torch.clamp(m_a - m_new, min=-80.0))
            r = torch.where(torch.isfinite(m_a), r, torch.zeros_like(r))
            o_a = o_a * r[..., None] + o
            d_a = d_a * r + e.sum(dim=-1)
            m_a = m_new
        out = o_a / torch.clamp(d_a[..., None], min=1e-30)
    # [n,B,nCl,nkv,C,g,hd] -> [n,B,Tl,nh,hd]
    return out.permute(0, 1, 2, 4, 3, 5, 6).reshape(n, B, Tl, nh, hd)


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
