"""Plain PyTorch version of the flash-attention kernel: the port of
``repro.kernels.flash_attention.ref``."""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, window=None, causal: bool = True,
                        scale=None):
    """q: [B, nkv, g, Tq, hd]; k, v: [B, nkv, Tk, hd] -> like q.

    Plain masked softmax attention in float32."""
    B, nkv, g, Tq, hd = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bngqh,bnkh->bngqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, torch.full((), -math.inf, device=q.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=q.device))
    p = torch.exp(s - m)
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bngqk,bnkh->bngqh", p / denom, v.to(torch.float32))
    return o.to(q.dtype)
