"""State-space and recurrent layers: Mamba2 (SSD, chunked) and the xLSTM
blocks (mLSTM chunkwise, sLSTM a time scan).

Port of ``repro.models.ssm``: plain functions over dicts of tensors, op
for op the reference's math, so float32 results agree within rounding.
Each ``lax.scan`` of the reference (over chunks for Mamba2 and mLSTM,
over steps for sLSTM) is a Python loop here, and autograd differentiates
it.  The reference's GSPMD constraint on Mamba2's channels changes no
value and has no counterpart.

Tensor parallelism.  Each block takes an optional ``tp``
(:class:`Ranks`): ``n`` TP ranks stacked into the batch dim, the input
``[n * B, T, d]`` (rank t's rows ``t * B .. (t + 1) * B``), each leaf
``[n, ...]`` the rank's own.  With ``split`` (megatron_sp) a rank holds
its heads (Mamba2, mLSTM) or units (sLSTM): its norm over the split dim
sums its squares over the ranks (:meth:`Ranks.norm`), a contraction over
the split dim with a replicated weight (mLSTM's gates) sums its partial
products over the ranks, and the block's output is the rank's partial
sum of the down projection, which the caller reduces.  Without it every
rank runs the whole block on its own copies.  With no ``tp`` (the
default) every op is the one-rank one.

Matching the reference's functions:

  * ``jax.nn.softplus`` is ``logaddexp(x, 0)``; so is :func:`_softplus`
    (``torch.nn.functional.softplus`` returns x itself past a threshold
    of 20, which differs from it by under one float32 ulp there);
  * ``jax.nn.log_sigmoid`` is ``F.logsigmoid``;
  * ``jnp.maximum`` and ``jnp.max`` split the gradient evenly among
    ties, as ``torch.maximum`` and ``torch.amax`` do (``Tensor.max(dim)``
    would send it to one index);
  * masked entries of an exponential (Mamba2's intra-chunk decay, mLSTM's
    log weights) are masked BEFORE ``exp``: the forward is the
    reference's (an exact 0 there), and the gradient stays finite where
    the reference's ``where(mask, exp(x), 0)`` would meet ``0 * inf``.

``norm`` is the RMSNorm the block's gated output goes through:
``layers.rmsnorm`` on the training path (it has a backward), the fused
kernel (``kernels.rmsnorm.ops.rmsnorm``) on the serving path.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.collectives import stacked

from . import layers as L

Norm = Callable[..., torch.Tensor]


class _One:
    """One rank (no ``tp``): every op as the reference's."""

    n, split = 1, False

    def dense(self, x, w):
        return L.dense(x, w)

    def rows(self, v, x):
        """``v [k]`` as ``[1, k]``, broadcast over the rows of ``x``."""
        return v[None]

    def tap(self, w, k: int):
        return w[k]

    def conv_step(self, h, w):
        return torch.einsum("bkc,kc->bc", h, w.to(h.dtype))

    def heads(self, uh, w):
        return torch.einsum("btnh,nhg->btng", uh, w)

    def gate(self, u, w):
        return L.dense(u, w)

    def norm(self, norm: Norm, y, w, eps: float):
        return norm(y, w, eps)


class Ranks(_One):
    """``n`` TP ranks stacked into the batch dim of a recurrent block (see
    the module docstring).  ``split``: each rank holds its heads or units
    (megatron_sp), else every rank the whole block (pure_sp)."""

    def __init__(self, n: int, split: bool):
        self.n, self.split = n, split

    def _ranked(self, x):
        return x.unflatten(0, (self.n, -1))

    def dense(self, x, w):
        """``x [n * B, ..., i]`` times each rank's ``w [n, i, o]``."""
        return L.dense_tp(self._ranked(x), w).flatten(0, 1)

    def rows(self, v, x):
        """Each rank's ``v [n, k]`` for each of its rows of ``x``:
        ``[n * B, k]``."""
        return v.repeat_interleave(x.shape[0] // self.n, dim=0)

    def tap(self, w, k: int):
        return w[:, k]

    def conv_step(self, h, w):
        return torch.einsum("rbkc,rkc->rbc", self._ranked(h),
                            w.to(h.dtype)).flatten(0, 1)

    def heads(self, uh, w):
        return torch.einsum("rbtnh,rnhg->rbtng", self._ranked(uh),
                            w).flatten(0, 1)

    def gate(self, u, w):
        """A contraction of ``u`` over the split dim with a replicated
        weight (``w [n, di / n, nh]``, the rank's rows): the ranks'
        partial products summed, each rank keeping its heads' columns (a
        reduce-scatter over the heads)."""
        y = self.dense(u, w)
        if not self.split:
            return y
        part = self._ranked(y)
        return stacked.psum_scatter(part, part.dim() - 2).flatten(0, 1)

    def norm(self, norm: Norm, y, w, eps: float):
        """The block's RMSNorm over its last dim with each rank's gain
        ``w [n, k]``: ``norm`` on each rank's whole row, or, split, the
        row's sum of squares reduced over the ranks (the plain ops of
        ``layers.rmsnorm``: the kernel normalises one rank's row)."""
        g = self.rows(w, y).view((y.shape[0],) + (1,) * (y.dim() - 2)
                                 + (w.shape[-1],))
        if not self.split:
            return norm(y, g, eps)
        return split_rmsnorm(y, g, eps, self.n)


_ONE = _One()

#: the ``torch.profiler`` range around each cross-rank norm
#: (``launch/profile_serve.py`` reads its device time)
SPLIT_NORM = "ssm.split_rmsnorm"


def split_rmsnorm(y, g, eps: float, n: int):
    """``layers.rmsnorm`` of rows split over ``n`` stacked ranks: ``y [n *
    B, ..., k]`` holds each rank's ``k`` of the row's ``n * k`` values,
    ``g`` the gains broadcast against it.  Each rank's sum of squares is
    summed over the ranks (``stacked.psum``, whose backward is a psum)
    before the scale."""
    with record_function(SPLIT_NORM):
        dt = y.dtype
        yf = y.to(torch.float32)
        ss = (yf * yf).sum(dim=-1, keepdim=True)
        ss = stacked.psum(ss.unflatten(0, (n, -1))).flatten(0, 1)
        out = yf * torch.rsqrt(ss / (n * y.shape[-1]) + eps)
        return (out * (1.0 + g.to(torch.float32))).to(dt)


def _softplus(x):
    """``jax.nn.softplus``: ``log(1 + e^x)`` as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _chunk_len(cfg, T: int) -> int:
    Q = min(cfg.ssm_chunk, T)
    if T % Q:
        raise ValueError(f"sequence {T} is not a multiple of ssm_chunk {Q} "
                         f"(prompts are multiples of it or shorter)")
    return Q


# ---------------------------------------------------------------------------
# Parameters: each leaf ``make(lead + shape, init[, dtype])`` (the
# convention of ``transformer._param_tree``)
# ---------------------------------------------------------------------------

def init_mamba2(cfg, make, lead: Tuple[int, ...] = ()) -> Dict[str, object]:
    """Split projections (z/x/B/C/dt), depthwise convs, the float32 SSM
    leaves ``A_log`` (zeros: A = -1), ``D`` (ones) and ``dt_bias``, the
    gated norm over d_inner and the output projection."""
    d = cfg.d_model
    din = cfg.ssm_expand * d
    nh = din // cfg.ssm_head_dim
    ds, K = cfg.ssm_state, cfg.ssm_conv

    def dense(i, o):
        return make(lead + (i, o), ("normal", 1.0 / math.sqrt(i)))

    return {
        "m_z": dense(d, din), "m_x": dense(d, din), "m_B": dense(d, ds),
        "m_C": dense(d, ds), "m_dt": dense(d, nh),
        "conv_x": make(lead + (K, din), ("normal", 0.2)),
        "conv_B": make(lead + (K, ds), ("normal", 0.2)),
        "conv_C": make(lead + (K, ds), ("normal", 0.2)),
        "A_log": make(lead + (nh,), ("zeros",), "float32"),
        "D": make(lead + (nh,), ("ones",), "float32"),
        "dt_bias": make(lead + (nh,), ("zeros",), "float32"),
        "norm": make(lead + (din,), ("zeros",)),
        "out_proj": dense(din, d),
    }


def init_mlstm(cfg, make, lead: Tuple[int, ...] = ()) -> Dict[str, object]:
    """The mLSTM block: up-projection by 2, block-diagonal per-head q/k/v
    ``[nh, hd, hd]`` in the inner dim, the gates, the norm over the inner
    dim, the down-projection."""
    d = cfg.d_model
    di = 2 * d
    nh = cfg.n_heads
    hd = di // nh

    def dense(i, o):
        return make(lead + (i, o), ("normal", 1.0 / math.sqrt(i)))

    blk = ("normal", 1.0 / math.sqrt(hd))
    return {"wup": dense(d, di), "wgate": dense(d, di),
            "wq": make(lead + (nh, hd, hd), blk),
            "wk": make(lead + (nh, hd, hd), blk),
            "wv": make(lead + (nh, hd, hd), blk),
            "wgi": dense(di, nh), "wgf": dense(di, nh),
            "norm": make(lead + (di,), ("zeros",)), "down": dense(di, d)}


def init_slstm(cfg, make, lead: Tuple[int, ...] = ()) -> Dict[str, object]:
    """The sLSTM block: input projections, per-unit recurrent weights
    ``r*`` (normal 0.1), the output projection and its norm."""
    d = cfg.d_model
    out = {k: make(lead + (d, d), ("normal", 1.0 / math.sqrt(d)))
           for k in ("wi", "wf", "wz", "wo")}
    out.update({k: make(lead + (d,), ("normal", 0.1))
                for k in ("ri", "rf", "rz", "ro")})
    out["out"] = make(lead + (d, d), ("normal", 1.0 / math.sqrt(d)))
    out["norm"] = make(lead + (d,), ("zeros",))
    return out


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def _causal_conv(x, w, tp=_ONE):
    """x: [B,T,C], w: [K,C] depthwise causal conv."""
    K = w.shape[-2]
    T = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pad[:, k:k + T, :] * tp.rows(tp.tap(w, k), x)[:, None, :]
    return out


def _conv_step(cs, xr, w, tp=_ONE):
    """Decode's conv: the state ``cs [B, K-1, C]`` and the new input
    ``xr [B, 1, C]`` -> (the conv output [B, 1, C], the next state)."""
    h = torch.cat([cs.to(torch.promote_types(cs.dtype, xr.dtype)),
                   xr.to(torch.promote_types(cs.dtype, xr.dtype))], dim=1)
    return tp.conv_step(h, w)[:, None, :], h[:, 1:]


def mamba2(p, cfg, x, state=None, return_state: bool = False,
           norm: Optional[Norm] = None, tp: Optional[Ranks] = None):
    """SSD forward.  x: [B,T,d].

    state (decode): dict(conv {x, B, C} [B,K-1,C], ssm [B,nh,hd,dstate])
    or None.  Chunked SSD over T otherwise; the single-step recurrence for
    decode (T == 1).  ``tp``: :class:`Ranks` (split: each rank its heads'
    channels of z, x and conv_x, its heads of A_log, D, dt_bias and
    m_dt's columns, B and C whole; the state ``[B, nh/n, hd, ds]``, conv
    ``x`` ``[B, K-1, din/n]``)."""
    norm = norm or L.rmsnorm
    tp = tp or _ONE
    B, T, d = x.shape
    hd = cfg.ssm_head_dim
    ds = cfg.ssm_state
    f32 = torch.float32

    z = tp.dense(x, p["m_z"])                      # [B,T,din]
    xr = tp.dense(x, p["m_x"])                     # [B,T,din]
    Br = tp.dense(x, p["m_B"])                     # [B,T,ds]
    Cr = tp.dense(x, p["m_C"])                     # [B,T,ds]
    dt_raw = tp.dense(x, p["m_dt"])                # [B,T,nh]
    din = z.shape[-1]                              # the rank's, split
    nh = din // hd

    if state is None:
        K1 = cfg.ssm_conv - 1
        new_conv = ({"x": xr[:, T - K1:], "B": Br[:, T - K1:],
                     "C": Cr[:, T - K1:]} if return_state else None)
        xr = _causal_conv(xr, p["conv_x"], tp)
        Br = _causal_conv(Br, p["conv_B"], tp)
        Cr = _causal_conv(Cr, p["conv_C"], tp)
    else:
        cs = state["conv"]
        xr, nx = _conv_step(cs["x"], xr, p["conv_x"], tp)
        Br, nb = _conv_step(cs["B"], Br, p["conv_B"], tp)
        Cr, nc = _conv_step(cs["C"], Cr, p["conv_C"], tp)
        new_conv = {"x": nx, "B": nb, "C": nc}
    xs = F.silu(xr).reshape(B, T, nh, hd)
    Bm = F.silu(Br)                                # [B,T,ds]
    Cm = F.silu(Cr)                                # [B,T,ds]

    dt_v = _softplus(dt_raw.to(f32)
                     + tp.rows(p["dt_bias"], x)[:, None, :])   # [B,T,nh]
    A = -torch.exp(p["A_log"])                                 # [nh]
    decay = dt_v * tp.rows(A, x)[:, None, :]       # log-decay per step

    if state is not None:
        # single step: S' = exp(decay)·S + dt·B⊗x ; y = C·S' + D·x
        S = state["ssm"]                                       # [B,nh,hd,ds]
        g = torch.exp(decay[:, 0, :])[:, :, None, None]
        upd = (dt_v[:, 0, :, None, None]
               * xs[:, 0, :, :, None].to(f32)
               * Bm[:, 0, None, None, :].to(f32))
        S = S * g + upd
        y = torch.einsum("bhps,bs->bhp", S, Cm[:, 0].to(f32))
        y = y + tp.rows(p["D"], x)[:, :, None] * xs[:, 0].to(f32)
        y = y.reshape(B, 1, din).to(x.dtype)
        out = tp.dense(tp.norm(norm, y * F.silu(z), p["norm"], cfg.norm_eps),
                       p["out_proj"])
        return out, {"conv": new_conv, "ssm": S}

    # ---- chunked SSD ----
    Q = _chunk_len(cfg, T)
    nQ = T // Q
    xs_c = xs.reshape(B, nQ, Q, nh, hd)
    B_c = Bm.reshape(B, nQ, Q, ds)
    C_c = Cm.reshape(B, nQ, Q, ds)
    cum = torch.cumsum(decay.reshape(B, nQ, Q, nh), dim=2)   # inclusive
    total = cum[:, :, -1:, :]                    # chunk total log decay
    dtc = dt_v.reshape(B, nQ, Q, nh)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ninf = torch.full((), -math.inf, device=x.device)

    S = torch.zeros((B, nh, hd, ds), dtype=f32, device=x.device)
    ys = []
    # each chunk's slices by ``unbind`` (whose backward stacks the chunks'
    # gradients once; an indexed slice's would zero-fill the whole tensor
    # per chunk)
    for xq, bq, cq, cumq, totq, dtq in zip(
            *(t.unbind(1) for t in (xs_c, B_c.to(f32), C_c.to(f32), cum,
                                    total, dtc))):
        # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j
        diff = cumq[:, :, None, :] - cumq[:, None, :, :]      # [B,Q,Q,nh]
        Lm = torch.exp(torch.where(tri[None, :, :, None], diff, ninf))
        sc = torch.einsum("bis,bjs->bij", cq, bq)             # [B,Q,Q]
        W = sc[..., None] * Lm                                # [B,Q,Q,nh]
        xw = xq.to(f32) * dtq[..., None]                      # dt-weighted x
        y_intra = torch.einsum("bijh,bjhp->bihp", W, xw)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bis,bhps->bihp", cq, S) \
            * torch.exp(cumq)[..., None]
        # S' = exp(total)·S + Σ_j exp(total-cum_j)·dt_j·B_j⊗x_j
        w_state = torch.exp(totq - cumq)                      # [B,Q,nh]
        S = S * torch.exp(totq[:, 0])[:, :, None, None] + torch.einsum(
            "bjhp,bjs->bhps", w_state[..., None] * xw, bq)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(B, T, nh, hd)
    y = y + tp.rows(p["D"], x)[:, None, :, None] * xs.to(f32)
    y = y.reshape(B, T, din).to(x.dtype)
    out = tp.dense(tp.norm(norm, y * F.silu(z), p["norm"], cfg.norm_eps),
                   p["out_proj"])
    if return_state:
        return out, {"conv": new_conv, "ssm": S}
    return out


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (chunkwise) and sLSTM (time scan)
# ---------------------------------------------------------------------------

def mlstm(p, cfg, x, state=None, return_state: bool = False,
          norm: Optional[Norm] = None, tp: Optional[Ranks] = None):
    """Chunkwise mLSTM: linear attention with exponential gating, log-space
    stable.  x: [B,T,d]; state: dict(C [B,nh,hd,hd], n [B,nh,hd], m
    [B,nh]) for decode.  Works in the 2x up-projected inner dim with
    block-diagonal q/k/v.  ``tp``: :class:`Ranks` (split: each rank its
    heads of the inner dim, of wq/wk/wv and of the state; the gates' rows
    of wgi/wgf, their partial products reduce-scattered over the
    heads)."""
    norm = norm or L.rmsnorm
    tp = tp or _ONE
    B, T, d = x.shape
    f32 = torch.float32
    u = tp.dense(x, p["wup"])                                 # [B,T,di]
    di = u.shape[-1]                              # the rank's, split
    hd = 2 * d // cfg.n_heads
    nh = di // hd
    uh = u.reshape(B, T, nh, hd)
    q = tp.heads(uh, p["wq"]) / math.sqrt(hd)
    k = tp.heads(uh, p["wk"])
    v = tp.heads(uh, p["wv"])
    i_pre = tp.gate(u, p["wgi"]).to(f32)                      # [B,T,nh]
    f_pre = tp.gate(u, p["wgf"]).to(f32)
    logf = F.logsigmoid(f_pre)                                # log forget

    if state is not None:  # decode: one step
        C, n, m = state["C"], state["n"], state["m"]
        m_new = torch.maximum(logf[:, 0] + m, i_pre[:, 0])
        fg = torch.exp(logf[:, 0] + m - m_new)[:, :, None, None]
        ig = torch.exp(i_pre[:, 0] - m_new)[:, :, None, None]
        kv = k[:, 0, :, :, None].to(f32) * v[:, 0, :, None, :].to(f32)
        C = C * fg + ig * kv
        n = n * fg[..., 0] + ig[..., 0] * k[:, 0].to(f32)
        qf = q[:, 0].to(f32)
        num = torch.einsum("bhk,bhkv->bhv", qf, C)
        den = torch.abs(torch.einsum("bhk,bhk->bh", qf, n))
        y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
        y = y.reshape(B, 1, di).to(x.dtype)
        return _mlstm_out(p, cfg, x, y, norm, tp), {"C": C, "n": n,
                                                    "m": m_new}

    Q = _chunk_len(cfg, T)
    nQ = T // Q
    qs, ks_, vs = (t.reshape(B, nQ, Q, nh, hd) for t in (q, k, v))
    is_ = i_pre.reshape(B, nQ, Q, nh)
    fs = logf.reshape(B, nQ, Q, nh)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device)
                     )[None, :, :, None]
    ninf = torch.full((), -math.inf, device=x.device)

    C = torch.zeros((B, nh, hd, hd), dtype=f32, device=x.device)
    n = torch.zeros((B, nh, hd), dtype=f32, device=x.device)
    m = torch.full((B, nh), -1e30, dtype=f32, device=x.device)
    ys = []
    for qf, kf, vf, ii, ff in zip(*(t.unbind(1) for t in (
            qs.to(f32), ks_.to(f32), vs.to(f32), is_, fs))):
        cumf = torch.cumsum(ff, dim=1)                         # [B,Q,nh]
        totf = cumf[:, -1, :]
        # log weights: intra a_ij = Σ_{l>j..i} f + i_j ; inter b_i = cumf_i + m
        la = cumf[:, :, None, :] - cumf[:, None, :, :] + ii[:, None, :, :]
        la = torch.where(tri, la, ninf)                        # [B,i,j,nh]
        lb = cumf + m[:, None, :]                              # [B,i,nh]
        m_i = torch.maximum(torch.amax(la, dim=2), lb)         # [B,Q,nh]
        wa = torch.exp(la - m_i[:, :, None, :])                # intra weights
        wb = torch.exp(lb - m_i)                               # inter weight
        sc = torch.einsum("bihk,bjhk->bijh", qf, kf)
        sw = sc * wa
        num = torch.einsum("bijh,bjhv->bihv", sw, vf)
        num = num + wb[..., None] * torch.einsum("bihk,bhkv->bihv", qf, C)
        den = sw.sum(dim=2) + wb * torch.einsum("bihk,bhk->bih", qf, n)
        ys.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_i))[..., None])
        # the carry, in max-stabilised space
        lk = totf[:, None] - cumf + ii                         # [B,Q,nh]
        m_new = torch.maximum(totf + m, torch.amax(lk, dim=1))
        wk = torch.exp(lk - m_new[:, None])
        decay = torch.exp(totf + m - m_new)
        C = C * decay[:, :, None, None] + torch.einsum(
            "bjhk,bjhv->bhkv", wk[..., None] * kf, vf)
        n = n * decay[:, :, None] + torch.einsum("bjh,bjhk->bhk", wk, kf)
        m = m_new
    y = torch.stack(ys, 1).reshape(B, T, di).to(x.dtype)
    out = _mlstm_out(p, cfg, x, y, norm, tp)
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


def _mlstm_out(p, cfg, x, y, norm: Norm, tp=_ONE):
    """Gated output + down-projection: y in the inner (2x) dim -> d (a
    rank's partial sum, split)."""
    og = torch.sigmoid(tp.dense(x, p["wgate"]))
    return tp.dense(tp.norm(norm, y, p["norm"], cfg.norm_eps) * og,
                    p["down"])


def slstm(p, cfg, x, state=None, return_state: bool = False,
          norm: Optional[Norm] = None, tp: Optional[Ranks] = None):
    """sLSTM with exponential gating and a stabiliser; a diagonal
    recurrence (per-unit recurrent weights), scanned over time.
    x: [B,T,d]; state: dict(c, n, h, m [B,d]) or None.  ``tp``:
    :class:`Ranks` (split: each rank its units: the columns of wi, wf,
    wz, wo, its r*, its state ``[B, d/n]``, the rows of ``out``; the
    recurrence is diagonal, so its scan needs no collective)."""
    norm = norm or L.rmsnorm
    tp = tp or _ONE
    B, T, _ = x.shape
    f32 = torch.float32
    # the four gates' input projections [4, B, T, d] and recurrent weights
    zs = torch.stack([tp.dense(x, p[k]).to(f32)
                      for k in ("wi", "wf", "wz", "wo")])
    d = zs.shape[-1]                              # the rank's units, split
    r = torch.stack([tp.rows(p[k].to(f32), x)
                     for k in ("ri", "rf", "rz", "ro")])       # [4, 1, d]
    if state is None:
        c = n = h = torch.zeros((B, d), dtype=f32, device=x.device)
        m = torch.full((B, d), -1e30, dtype=f32, device=x.device)
    else:
        c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    one = torch.ones((), dtype=f32, device=x.device)
    hs = []
    for zs_t in zs.unbind(2):      # (see mamba2's loop on unbind)
        g = torch.addcmul(zs_t, h[None], r)                    # [4, B, d]
        it, ft = g[0], g[1]
        zt = torch.tanh(g[2])
        ot = torch.sigmoid(g[3])
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        ig = torch.exp(it - m_new)
        fg = torch.exp(logf + m - m_new)
        c = fg * c + ig * zt
        n = fg * n + ig
        # n is exactly 1 after the first step: the tie splits the gradient
        h = ot * c / torch.maximum(n, one)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, 1).to(x.dtype)
    out = tp.dense(tp.norm(norm, y, p["norm"], cfg.norm_eps), p["out"])
    if return_state:
        return out, {"c": c, "n": n, "h": h, "m": m}
    return out
