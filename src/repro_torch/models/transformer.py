"""Decoder LM backbone: pattern-segmented layer stack.

Port of ``repro.models.transformer``: the ``attn`` and ``moe`` blocks, the
recurrent ones, ``mamba2``, ``mlstm`` and ``slstm`` (``models.ssm``),
with zamba2's weight-tied ``shared_attn`` block, and the frontend stubs'
input projection (musicgen-medium, pixtral-12b): float ``[B, T,
frontend_dim]`` frames enter through ``frontend_proj``, int tokens
through ``embed``.  Every block trains over stacked TP ranks and serves
over them in the fixed-batch loop, as the reference's GSPMD step and
serve functions do.  Frames are float32 and
every product promotes as ``jnp.einsum`` does (``layers.dense``), so a
bf16 frontend model fed frames runs its residual stream, Q/K/V and logits
in float32 over bf16 weights, as the reference's does; its caches are
cast to ``cache_dtype``.  The parameter tree keeps the reference's
layout — ``segments[i]`` leaves are stacked ``[n_layers_in_segment, ...]``, a
``shared_attn`` firing's segment is ``{}`` and its weights live once in
``params["shared"]`` — and each leaf the reference's dtype (Mamba2's
``A_log``, ``D`` and ``dt_bias`` are float32 in a bf16 model), so trees
cross between the packages leaf for leaf (``repro_torch.interop``).
Layers of a segment run in a Python loop over the stacked leaves (the
reference's ``lax.scan``); the shared block's gradient sums over its
firings, as autograd adds a reused leaf's.  Under ``cfg.remat`` (the
reference's default; ``reduced`` turns it off) each layer of a segment is
rematerialized as the reference's ``jax.checkpoint(body)`` is
(:func:`_remat`): its activations are recomputed in the backward, to the
same bits, and the ``shared_attn`` firings, applied outside the
reference's scan, are not.

Two paths, as in the reference: ``forward``/``loss_fn`` (training, through
autograd) keep the plain ``layers.rmsnorm`` and the query-chunked
``layers.attention`` — with ``n_model > 1`` the TP ranks of one DP rank
run stacked, ``megatron_sp`` or ``pure_sp`` (section "Tensor
parallelism" below); the serving half (``prefill``, ``decode_step``) puts
every norm on the RMSNorm kernel (the recurrent blocks' gated norms
among them) and prefill's attention core on the flash-attention kernel,
which have no backward; ``prefill_tp`` and ``decode_step_tp`` serve over
stacked TP ranks (section "Serving under tensor parallelism" below).
Decode attention stays plain torch: each slot sits at its own position,
which the flash kernel's ``qpos = q_start + row`` cannot express (the
reference computes it outside any Pallas kernel too).

Decode caches are updated IN PLACE (the reference returns new arrays): a
page pool holds every layer's K/V, and copying it per token would move
the whole pool each step.  ``decode_step`` returns the state it was given,
with its K/V caches written and a new ``pos``; a recurrent segment's
states are replaced by the step's new ones (the reference's dtypes: a
float32 model's conv state leaves a bf16 cache as float32 after its first
step, as the reference's concatenation promotes it).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.collectives import stacked

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm as fused_rmsnorm
from repro_torch.obs import metrics as OM

from . import layers as L
from . import moe as M
from . import sharding as SH
from . import ssm as S


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


#: the blocks whose prefill and decode hold K/V caches
ATTN_KINDS = ("attn", "moe", "shared_attn")
#: the recurrent blocks (``models.ssm``), whose decode state is theirs
RECURRENT = ("mamba2", "mlstm", "slstm")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _block_tree(cfg, block: Block, make, lead: Tuple[int, ...]
                ) -> Dict[str, Any]:
    """One block's leaves, each ``make(lead + shape, init[, dtype])``."""
    d, nh, nkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)

    def dense(i, o):
        return make(lead + (i, o), ("normal", 1.0 / math.sqrt(i)))

    def gain(n):
        return make(lead + (n,), ("zeros",))

    def mlp():
        return {"wi": dense(d, f), "wg": dense(d, f), "wo": dense(f, d)}

    if block.kind in ATTN_KINDS:
        attn = {"wq": dense(d, nh * hd), "wk": dense(d, nkv * hd),
                "wv": dense(d, nkv * hd), "wo": dense(nh * hd, d)}
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = gain(hd), gain(hd)
        p = {"ln1": gain(d), "attn": attn, "ln2": gain(d)}
        if block.kind == "moe":
            p["moe"] = M.init_moe(cfg, make, lead)
        else:
            p["mlp"] = mlp()
        return p
    if block.kind == "mamba2":
        p = {"ln1": gain(d), "mamba": S.init_mamba2(cfg, make, lead)}
        # zamba2: Mamba blocks carry no FFN — d_ff is the shared block's
        if cfg.block_pattern != "zamba":
            p["ln2"], p["mlp"] = gain(d), mlp()
        return p
    if block.kind == "mlstm":
        return {"ln1": gain(d), "mlstm": S.init_mlstm(cfg, make, lead)}
    if block.kind == "slstm":
        return {"ln1": gain(d), "slstm": S.init_slstm(cfg, make, lead)}
    raise ValueError(block.kind)


def _param_tree(cfg, make) -> Dict[str, Any]:
    """The parameter tree, each leaf ``make(shape, init[, dtype])`` with
    init one of ``("normal", std)``, ``("zeros",)`` or ``("ones",)`` and
    dtype the leaf's where it is not ``cfg.dtype`` (Mamba2's float32 SSM
    leaves)."""
    d = cfg.d_model
    params: Dict[str, Any] = {}
    if cfg.frontend is not None:
        # the modality frontend stub: precomputed frames enter through a
        # trainable projection; ``embed`` stays, as in the reference
        params["frontend_proj"] = make((cfg.frontend_dim, d),
                                       ("normal", 1.0 / math.sqrt(
                                           cfg.frontend_dim)))
    params["embed"] = make((cfg.vocab_size, d), ("normal", 0.02))
    segs = []
    for block, n in segments(cfg):
        # a shared_attn firing: weight-tied, its leaves in params["shared"]
        segs.append({} if block.kind == "shared_attn"
                    else _block_tree(cfg, block, make, (n,)))
    params["segments"] = segs
    if any(b.kind == "shared_attn" for b, _ in segments(cfg)):
        params["shared"] = _block_tree(cfg, Block("shared_attn"), make, ())
    params["final_norm"] = make((d,), ("zeros",))
    if not cfg.tie_embeddings:
        params["lm_head"] = make((d, cfg.vocab_size),
                                 ("normal", 1.0 / math.sqrt(d)))
    return params


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree as ``meta`` tensors: shapes and dtypes only."""
    return _param_tree(cfg, lambda shape, init, dtype=None: torch.empty(
        shape, dtype=getattr(torch, dtype or cfg.dtype), device="meta"))


def init_params(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters from ``seed``: the reference's distributions
    (normal weights scaled 1/sqrt(fan_in), embedding std 0.02, zero norm
    gains, the recurrent blocks' constants), drawn in float32 and cast to
    each leaf's dtype.  The draws differ from ``jax.random``'s; tests
    carry JAX's weights across instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(shape, init, dtype=None):
        dt = getattr(torch, dtype or cfg.dtype)
        if init[0] in ("zeros", "ones"):
            fill = torch.zeros if init[0] == "zeros" else torch.ones
            return fill(shape, dtype=dt, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * init[1]).to(dt)

    return _param_tree(cfg, make)


def param_count(params) -> int:
    return sum(int(math.prod(x.shape)) for x in T.flatten(params))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

#: a recurrent block's sublayer key in its parameter tree
_SUBLAYER = dict(zip(RECURRENT, ("mamba", "mlstm", "slstm")))


def _recurrent(p, cfg, block: Block, x, norm, state=None):
    """A recurrent block (``models.ssm``) with every norm ``norm``
    (``layers.rmsnorm`` to train, the fused kernel to serve) over ``x``,
    from ``state`` (decode) or none: (x', its state at the end of x)."""
    h, st = getattr(S, block.kind)(
        p[_SUBLAYER[block.kind]], cfg, norm(x, p["ln1"], cfg.norm_eps),
        state=state, return_state=True, norm=norm)
    x = x + h
    if "mlp" in p:          # a Mamba2 block outside zamba
        x = x + L.mlp(p["mlp"], cfg, norm(x, p["ln2"], cfg.norm_eps))
    return x, st


def _apply_block(p, cfg, block: Block, x, positions):
    """One layer forward: (x', its MoE aux, or None for another layer)."""
    eps = cfg.norm_eps
    if block.kind in _SUBLAYER:
        return _recurrent(p, cfg, block, x, L.rmsnorm)[0], None
    h = L.attention(p["attn"], cfg, L.rmsnorm(x, p["ln1"], eps),
                    positions, window=block.window)
    x = x + h
    y = L.rmsnorm(x, p["ln2"], eps)
    if block.kind == "moe":
        m, aux = M.moe(p["moe"], cfg, y)
        return x + m, aux
    return x + L.mlp(p["mlp"], cfg, y), None


#: the ``torch.profiler`` range around a layer's recompute under remat
#: (``launch/profile_step.py`` splits its time from the forward's and the
#: backward's)
RECOMPUTE = "remat.recompute"


@contextlib.contextmanager
def _recomputing():
    """A layer's recompute in the backward: in its own profiler range, and
    with the obs registry off, so each collective the layer calls
    (``moe._moe_ep``'s all_to_all) is recorded once a step with remat on
    or off, as the reference's, recorded at trace time, is under
    ``jax.checkpoint``.  Kernel launches (``build.LAUNCHES``) still count:
    they are real."""
    with record_function(RECOMPUTE), OM.disabled():
        yield


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


def _remat(cfg, layer, x):
    """``layer(x)`` -> (x', aux or None), rematerialized under
    ``cfg.remat`` as the reference's ``jax.checkpoint(body)``: autograd
    keeps only ``x`` and recomputes the layer's activations in the
    backward, where they are needed.  The recompute runs the same ops on
    the same inputs, so the gradients are the same bits.  The aux comes
    out of the checkpoint as an output.  Without autograd (serving, a
    ``no_grad`` forward) nothing is kept either way, so the layer runs
    plain.  The layers draw no random numbers: no RNG state is kept."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return layer(x)
    return checkpoint(layer, x, use_reentrant=False,
                      context_fn=_remat_contexts, preserve_rng_state=False)


def _layer(seg_p, l: int):
    """Layer ``l``'s parameters out of a stacked segment tree."""
    if isinstance(seg_p, dict):
        return {k: _layer(v, l) for k, v in seg_p.items()}
    return seg_p[l]


def forward(params, cfg, inputs, positions=None, n_model: int = 1):
    """inputs: [B,T] int tokens or [B,T,frontend_dim] float frames.
    Returns (logits [B,T,V], aux_loss: the MoE layers' aux summed, 0 for
    a dense model).

    ``n_model > 1``: ``params`` stacked over the TP ranks
    (``sharding.shard_params``), every rank given the same ``inputs``;
    returns the vocab-sharded logits ``[n, B, T, V/n]`` and ``aux [n]``
    (:func:`forward_tp`)."""
    if n_model > 1:
        if positions is not None:
            raise ValueError("the TP forward runs positions 0..T-1")
        return forward_tp(params, cfg, inputs, n_model)
    B, T = inputs.shape[:2]
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=inputs.device)
    x = _embed(params, cfg, inputs)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (block, n), seg_p in zip(segments(cfg), params["segments"]):
        if block.kind == "shared_attn":
            x, _ = _apply_block(params["shared"], cfg, block, x, positions)
            continue
        for l in range(n):
            # the recompute calls the layer after the loop has moved on:
            # its parameters and block are bound now
            x, aux = _remat(cfg, lambda h, p=_layer(seg_p, l), b=block:
                            _apply_block(p, cfg, b, h, positions), x)
            if aux is not None:
                aux_total = aux_total + aux
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return L.dense(x, head), aux_total


def loss_fn(params, cfg, batch, n_model: int = 1
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: dict(inputs [B,T] or [B,T,F], targets [B,T], optional mask
    [B,T]).

    Cross entropy in fp32 with z-loss; returns (loss, metrics).  With
    ``n_model > 1`` every value is per TP rank, ``[n]`` (all equal):
    :func:`loss_fn_tp`."""
    if n_model > 1:
        return loss_fn_tp(params, cfg, batch, n_model)
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
# Tensor parallelism: the TP ranks of one DP rank stacked [n, ...]
# ---------------------------------------------------------------------------
# The reference's TP is GSPMD's: one program on global arrays, laid out by
# the specs of ``sharding``.  Here each rank's share is explicit and the
# collectives GSPMD inserts are the rank-dim built-ins of
# ``collectives.stacked``, which autograd differentiates like any tensor
# op.  Weights are held as ``sharding.shard_params`` stacks them; each
# contraction runs on the rank's Megatron block of its weight: the column
# block of wq/wk/wv/wi/wg and the vocab-sharded head, the row block of wo.
# Where the specs shard a weight on another dim (a segment's wi/wg/wo
# take the layer dim) it is all-gathered over the ranks first, as GSPMD
# must.  The residual stream between blocks is sequence-sharded
# ``[n, B, T/n, d]`` when T divides by n, else every rank holds it whole.
#
# A recurrent block (``_recurrent_tp``) runs over the whole sequence: each
# rank gathers it, then under megatron_sp runs its own heads (Mamba2,
# mLSTM) or units (sLSTM) and its partial down projection is reduced into
# the stream, as a row-parallel product is; under pure_sp (and a Mamba2
# whose heads do not divide the ranks) every rank runs the whole block on
# its own copies and keeps its own sequence block, so the gather's
# backward, a reduce-scatter, counts every token's gradient once.

class _TP:
    """The layout of one TP forward: ``n`` ranks, its strategy, and
    whether the residual stream is sequence-sharded."""

    def __init__(self, cfg, n: int, T: int):
        self.n, self.strat, self.sp = n, SH.strategy(cfg, n), T % n == 0

    def gather(self, x):
        """The residual stream -> the whole sequence on every rank."""
        return SH.seq_gather(x) if self.sp else x

    def reduce(self, x):
        """Partial sums over the ranks -> the residual stream."""
        return SH.seq_reduce_scatter(x) if self.sp else stacked.psum(x)

    def own(self, x):
        """The whole sequence on every rank -> the residual stream (each
        rank's own sequence block; no communication)."""
        return SH.rank_block(x, 1) if self.sp else x


#: per-rank dim of each weight's Megatron block in a segment leaf
#: ``[n_layers, d_in, d_out]``: the column block of the input projections,
#: the row block of the output ones
_MEGATRON_DIM = {"wq": 2, "wk": 2, "wv": 2, "wi": 2, "wg": 2, "wo": 1}


def _bw(w, x):
    """A stacked norm gain ``w [n, d]`` broadcast against ``x [n, ..., d]``."""
    return w.reshape((w.shape[0],) + (1,) * (x.dim() - 2) + (w.shape[-1],))


def _block_of(w, md: int, dim: int):
    """Each rank's block of per-rank dim ``dim`` of weight ``w``, held as
    ``sharding.shard_params`` stacks it on ``md``: the rank's own shard
    when that is the dim, else (``md >= 0``) all-gathered over the ranks
    first, then split."""
    if md == dim:
        return w
    if md >= 0:
        w = stacked.all_gather(w, md)
    return SH.rank_block(w, dim)


def _vocab_block(w, md: int, dim: int):
    """Each rank's vocab block of the embedding ``[n, V, d]`` (``dim`` 0)
    or the head ``[n, d, V]`` (1), as :func:`_block_of`.  A vocab that
    does not divide the ranks is held whole (``md < 0``, as the
    reference's GSPMD step replicates it) and zero-padded at its end to
    ``n * ceil(V / n)`` first: no token looks up a padded row, and
    :func:`loss_fn_tp` leaves the padded logits out."""
    n, V = w.shape[0], w.shape[dim + 1]
    if md < 0 and V % n:
        after = w.dim() - 2 - dim          # dims after the vocab dim
        w = torch.nn.functional.pad(w, (0, 0) * after + (0, -V % n))
    return _block_of(w, md, dim)


#: each leaf of a recurrent sublayer that splits over the TP ranks under
#: megatron_sp (``recurrent_split``), with the dim of its heads, channels
#: or units in a layer's leaf: the specs' sharded leaves, and the
#: replicated ones of which each rank reads its own block (Mamba2's m_dt
#: columns, mLSTM's wq/wk/wv heads and wgi/wgf rows, sLSTM's wi/wf/wo
#: columns and out rows, every norm gain); a leaf not named (Mamba2's B
#: and C projections and convs) every rank reads whole
_SPLIT_DIM = {
    "mamba": {"m_z": 1, "m_x": 1, "m_dt": 1, "conv_x": 1, "A_log": 0,
              "D": 0, "dt_bias": 0, "norm": 0, "out_proj": 0},
    "mlstm": {"wup": 1, "wgate": 1, "wq": 0, "wk": 0, "wv": 0, "wgi": 0,
              "wgf": 0, "norm": 0, "down": 0},
    "slstm": {"wi": 1, "wf": 1, "wz": 1, "wo": 1, "ri": 0, "rf": 0, "rz": 0,
              "ro": 0, "norm": 0, "out": 0},
}


def recurrent_split(cfg, kind: str, n: int) -> bool:
    """Whether a recurrent block's heads or units split over ``n`` TP
    ranks: under megatron_sp, Mamba2 where its heads divide n (the
    reference shards its channels only then, ``ssm.py:107-108``), mLSTM
    where its heads do (each rank's slice of the inner dim whole heads of
    the block-diagonal q/k/v), sLSTM where its units do.  Else every rank
    runs it whole."""
    if SH.strategy(cfg, n) != "megatron_sp":
        return False
    if kind == "mamba2":
        return (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim) % n == 0
    if kind == "mlstm":
        return cfg.n_heads % n == 0
    return cfg.d_model % n == 0


def _megatron_sub(sub, md, dims, kv_whole: bool = False):
    """One sublayer's leaves as its contractions read them: each leaf
    named in ``dims`` the rank's block of that per-rank dim
    (:func:`_block_of`), K/V whole under the GQA rule (``kv_whole``),
    every other leaf whole (all-gathered where the specs shard it)."""
    def one(k, w):
        if k in dims and not (kv_whole and k in ("wk", "wv")):
            return _block_of(w, md[k], dims[k])
        return stacked.all_gather(w, md[k]) if md[k] >= 0 else w
    return {k: one(k, w) for k, w in sub.items()}


def _megatron_layout(params, cfg, tp: _TP):
    """``params`` as the contractions read them: the vocab block of the
    embedding (and head, :func:`_vocab_block`); under megatron_sp also
    each weight's Megatron block (``_MEGATRON_DIM``; the shared block's
    ``_SERVE_DIM``), where K/V stay whole under the GQA rule
    (``n_kv_heads % n != 0``: the heads split after the repeat), and each
    recurrent leaf's block of its heads or units (``_SPLIT_DIM``, where
    ``recurrent_split``; else every leaf whole).  The expert blocks of a
    ``moe`` sublayer stay each rank's shard for expert parallelism; where
    the stream is not sequence-sharded (T % n != 0) ``moe.moe`` runs the
    dense path, and a sharded expert leaf is all-gathered over the ranks
    first."""
    mds = SH.model_dims(cfg, param_shapes(cfg), tp.n)
    out = dict(params)
    out["embed"] = _vocab_block(params["embed"], mds["embed"], 0)
    if "lm_head" in params:
        out["lm_head"] = _vocab_block(params["lm_head"], mds["lm_head"], 1)
    if tp.strat != "megatron_sp":
        return out
    kv_whole = cfg.n_kv_heads % tp.n != 0
    segs = []
    for (block, _), seg, md in zip(segments(cfg), params["segments"],
                                   mds["segments"]):
        seg = dict(seg)
        for sub in ("attn", "mlp"):
            if sub in seg:
                seg[sub] = _megatron_sub(seg[sub], md[sub], _MEGATRON_DIM,
                                         kv_whole)
        if block.kind in _SUBLAYER:
            sub = _SUBLAYER[block.kind]
            split = recurrent_split(cfg, block.kind, tp.n)
            seg[sub] = _megatron_sub(
                seg[sub], md[sub], {k: d + 1 for k, d in
                                    _SPLIT_DIM[sub].items()} if split else {})
        if "moe" in seg and not tp.sp:
            seg["moe"] = {k: w if md["moe"][k] < 0 else
                          stacked.all_gather(w, md["moe"][k])
                          for k, w in seg["moe"].items()}
        segs.append(seg)
    out["segments"] = segs
    if "shared" in params:
        out["shared"] = dict(params["shared"])
        for sub in ("attn", "mlp"):
            out["shared"][sub] = _megatron_sub(
                params["shared"][sub], mds["shared"][sub], _SERVE_DIM,
                kv_whole)
    return out


def _embed_tp(E, cfg, tokens, tp: _TP):
    """The vocab-sharded lookup of ``E [n, V/n, d]``: each rank gathers the
    rows of its vocab block (zeros elsewhere), reduced over the ranks into
    the residual stream (exact: one non-zero term per token)."""
    n, Vl = E.shape[0], E.shape[1]
    off = (torch.arange(n, device=E.device) * Vl)[:, None, None]
    ids = tokens.long()[None] - off                              # [n, B, T]
    ok = (ids >= 0) & (ids < Vl)
    # an embedding lookup into the ranks' stacked rows: its backward
    # accumulates in a fixed order (advanced indexing's does not, on the
    # CPU)
    rows = torch.nn.functional.embedding(torch.clamp(ids, 0, Vl - 1) + off,
                                         E.reshape(n * Vl, -1))
    x = tp.reduce(torch.where(ok[..., None], rows,
                              torch.zeros((), dtype=rows.dtype,
                                          device=rows.device)))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _frames_tp(W, frames, tp: _TP):
    """Float frames ``[B, T, F]`` through the replicated ``frontend_proj``
    ``W [n, F, d]`` into the residual stream: each rank projects its own
    sequence shard (the whole sequence when T does not divide n), with
    its own copy of W, whose gradients the step sums over the TP ranks as
    for every replicated leaf."""
    n = W.shape[0]
    x = SH.seq_shard(frames, n) if tp.sp else \
        frames.expand((n,) + tuple(frames.shape))
    return L.dense_tp(x, W)


def _qkv_tp(p, cfg, h, pos, tp: _TP):
    """Each rank's rotated Q, K and V of the normed residual stream ``h``:
    under megatron_sp the whole sequence's heads of the rank's column
    blocks (``[n, B, T, heads, hd]``; K/V whole under the GQA rule, when
    ``p``'s wk/wv are), under pure_sp every head of the rank's own tokens
    (``[n, B, T/n, heads, hd]``)."""
    n = tp.n
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if tp.strat == "megatron_sp":
        hf = tp.gather(h)                                     # [n,B,T,d]
        B, T = hf.shape[1], pos.shape[0]
        q = L.dense_tp(hf, p["wq"]).reshape(n, B, T, nh // n, hd)
        k = L.dense_tp(hf, p["wk"])
        v = L.dense_tp(hf, p["wv"])
        k = k.reshape(n, B, T, k.shape[-1] // hd, hd)
        v = v.reshape(n, B, T, v.shape[-1] // hd, hd)
        qpos = pos
    else:
        B, Tl = h.shape[1], h.shape[2]
        q = L.dense_tp(h, p["wq"]).reshape(n, B, Tl, nh, hd)
        k = L.dense_tp(h, p["wk"]).reshape(n, B, Tl, nkv, hd)
        v = L.dense_tp(h, p["wv"]).reshape(n, B, Tl, nkv, hd)
        qpos = pos.reshape(n, Tl)[:, None]
    if cfg.qk_norm:
        q = L.rmsnorm(q, _bw(p["q_norm"], q), cfg.norm_eps)
        k = L.rmsnorm(k, _bw(p["k_norm"], k), cfg.norm_eps)
    return (L.rope(q, qpos, cfg.rope_theta), L.rope(k, qpos, cfg.rope_theta),
            v)


def _attn_tp(p, cfg, block: Block, h, pos, tp: _TP):
    """One attention sublayer on the normed residual stream ``h``."""
    n = tp.n
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = pos.shape[0]
    C = min(cfg.attn_chunk, T)
    if T % C:
        raise ValueError(f"sequence {T} is not a multiple of attn_chunk {C}")
    scale = 1.0 / math.sqrt(hd)
    if tp.strat == "megatron_sp":
        q, k, v = _qkv_tp(p, cfg, h, pos, tp)
        B = q.shape[1]
        g = nh // nkv
        kf = k.repeat_interleave(g, dim=3)
        vf = v.repeat_interleave(g, dim=3)
        if kf.shape[3] != nh // n:   # GQA: K/V whole, the heads split now
            kf, vf = SH.rank_block(kf, 2), SH.rank_block(vf, 2)
        out = L._attn_head_parallel(q.flatten(0, 1), kf.flatten(0, 1),
                                    vf.flatten(0, 1), pos, block.window,
                                    scale, C)
        out = out.reshape(n, B, T, (nh // n) * hd).to(h.dtype)
        return tp.reduce(L.dense_tp(out, p["wo"]))
    if not tp.sp:
        # pure_sp with T % n != 0: the reference falls through to the
        # single path; every rank runs it on its own copies
        return torch.stack([L.attention({k: v[t] for k, v in p.items()},
                                        cfg, h[t], pos, window=block.window)
                            for t in range(n)])
    q, k, v = _qkv_tp(p, cfg, h, pos, tp)
    out = _seq_parallel_attn(cfg, block, q, SH.seq_gather(k),
                             SH.seq_gather(v), pos, n)
    return L.dense_tp(out.to(h.dtype), p["wo"])


def _seq_parallel_attn(cfg, block: Block, q, k, v, pos, n: int):
    """pure_sp attention: each rank's query chunks ``q [n, B, T/n, nh,
    hd]`` against the whole sequence's ``k``/``v`` (each rank's gathered
    copy) -> ``[n, B, T/n, nh * hd]`` float32."""
    B, Tl, nh, hd = q.shape[1:]
    T = pos.shape[0]
    C = min(cfg.attn_chunk, T)
    # the q-chunk grid must split over the ranks: grow chunks if it does not
    Cq = C if (T // C) % n == 0 else T // n
    out = L._attn_seq_parallel(q, k, v, pos.reshape(n, Tl), block.window,
                               1.0 / math.sqrt(hd), Cq)
    return out.reshape(n, B, Tl, nh * hd)


def _mlp_tp(p, cfg, y, tp: _TP):
    """The MLP: column-parallel wi/wg and row-parallel wo under
    megatron_sp; under pure_sp each rank's tokens through its own copy."""
    mega = tp.strat == "megatron_sp"
    if mega:
        y = tp.gather(y)
    h, gate = L.dense_tp(y, p["wi"]), L.dense_tp(y, p["wg"])
    if cfg.act == "geglu":
        h = torch.nn.functional.gelu(gate, approximate="tanh") * h
    else:  # swiglu
        h = torch.nn.functional.silu(gate) * h
    out = L.dense_tp(h, p["wo"])
    return tp.reduce(out) if mega else out


def _recurrent_tp(p, cfg, block: Block, x, tp: _TP):
    """A recurrent layer of the TP forward on the residual stream ``x``:
    each rank gathers the whole sequence and runs the block
    (``models.ssm`` over :class:`ssm.Ranks`), split over its heads or
    units (its partial down projection reduced into the stream) or whole
    (its own sequence block kept)."""
    eps = cfg.norm_eps
    h = tp.gather(L.rmsnorm(x, _bw(p["ln1"], x), eps))       # [n,B,T,d]
    split = recurrent_split(cfg, block.kind, tp.n)
    out = getattr(S, block.kind)(
        p[_SUBLAYER[block.kind]], cfg, h.flatten(0, 1),
        tp=S.Ranks(tp.n, split)).unflatten(0, (tp.n, -1))
    x = x + (tp.reduce(out) if split else tp.own(out))
    if "mlp" in p:          # a Mamba2 block outside zamba
        x = x + _mlp_tp(p["mlp"], cfg, L.rmsnorm(x, _bw(p["ln2"], x), eps),
                        tp)
    return x


def _block_tp(p, cfg, block: Block, x, pos, tp: _TP):
    """One layer of the TP forward on the residual stream ``x``: (x', its
    MoE aux ``[n]``, or None for another layer)."""
    if block.kind in _SUBLAYER:
        return _recurrent_tp(p, cfg, block, x, tp), None
    x = x + _attn_tp(p["attn"], cfg, block,
                     L.rmsnorm(x, _bw(p["ln1"], x), cfg.norm_eps), pos, tp)
    y = L.rmsnorm(x, _bw(p["ln2"], x), cfg.norm_eps)
    if block.kind == "moe":
        m, aux = M.moe(p["moe"], cfg, y, tp.n, tp.sp)
        return x + m, aux
    return x + _mlp_tp(p["mlp"], cfg, y, tp), None


def _layer_tp(seg, l: int):
    """Layer ``l`` of a stacked segment (leaves ``[n, n_layers, ...]``)."""
    if isinstance(seg, dict):
        return {k: _layer_tp(v, l) for k, v in seg.items()}
    return seg[:, l]


def forward_tp(params, cfg, inputs, n_model: int):
    """The TP forward of one DP rank: ``params`` from
    ``sharding.shard_params``, ``inputs [B, T]`` tokens or ``[B, T, F]``
    frames (every TP rank reads the same inputs).  Returns the
    vocab-sharded logits ``[n, B, T, V/n]`` and ``aux [n]`` (the MoE
    layers' aux summed, the same on every rank); for
    a vocab that does not divide n, ``[n, B, T, ceil(V/n)]`` with zeros in
    the last rank's padded columns (the logits of vocab ids ``>= V``)."""
    T_ = inputs.shape[1]
    tp = _TP(cfg, n_model, T_)
    params = _megatron_layout(params, cfg, tp)
    pos = torch.arange(T_, dtype=torch.int32, device=inputs.device)
    if _is_frames(cfg, inputs):
        x = _frames_tp(params["frontend_proj"], inputs, tp)
    else:
        x = _embed_tp(params["embed"], cfg, inputs, tp)
    aux_total = torch.zeros(n_model, dtype=torch.float32, device=x.device)
    for (block, nl), seg in zip(segments(cfg), params["segments"]):
        if block.kind == "shared_attn":
            x, _ = _block_tp(params["shared"], cfg, block, x, pos, tp)
            continue
        for l in range(nl):
            x, aux = _remat(cfg, lambda h, p=_layer_tp(seg, l), b=block:
                            _block_tp(p, cfg, b, h, pos, tp), x)
            if aux is not None:
                aux_total = aux_total + aux
    x = tp.gather(L.rmsnorm(x, _bw(params["final_norm"], x), cfg.norm_eps))
    head = params["embed"].transpose(1, 2) if cfg.tie_embeddings \
        else params["lm_head"]
    logits = L.dense_tp(x, head)
    return logits, aux_total


def loss_fn_tp(params, cfg, batch, n_model: int):
    """:func:`loss_fn` over the vocab-sharded logits: the logsumexp from
    the ranks' maxima (all-gathered) and their sums of exponentials
    (psum), the target logit picked by the rank whose block holds it
    (psum), and the token mean of the sequence shards' sums (psum).
    The padded logits of a vocab that does not divide n are -inf, out of
    the logsumexp.  Every value is ``[n]``, the same on every rank."""
    logits, aux = forward_tp(params, cfg, batch["inputs"], n_model)
    logits = logits.to(torch.float32)                    # [n,B,T,V/n]
    n, B, T_, Vl = logits.shape
    if n * Vl != cfg.vocab_size:
        ids = torch.arange(n * Vl, device=logits.device).view(n, 1, 1, Vl)
        logits = torch.where(ids < cfg.vocab_size, logits,
                             torch.full((), float("-inf"),
                                        device=logits.device))
    mx = stacked.all_gather(torch.amax(logits, dim=-1, keepdim=True), -1)
    mx = torch.amax(mx, dim=-1).detach()                 # [n,B,T]
    se = stacked.psum(torch.exp(logits - mx[..., None]).sum(dim=-1))
    lse = mx + torch.log(se)
    ids = batch["targets"].long()[None] - (
        torch.arange(n, device=logits.device) * Vl)[:, None, None]
    ok = (ids >= 0) & (ids < Vl)
    pick = torch.gather(logits, -1, torch.clamp(ids, 0, Vl - 1)[..., None])
    tgt = stacked.psum(torch.where(ok, pick[..., 0],
                                   torch.zeros((), device=logits.device)))
    nll = lse - tgt
    del logits, pick
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones((B, T_), dtype=torch.float32, device=nll.device)
    mask = mask.to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)

    def token_sum(v):
        """Sum over the tokens: each rank its sequence shard, then psum."""
        if T_ % n:
            return (v * mask).sum(dim=(1, 2))
        ms = SH.seq_shard(mask, n)
        return stacked.psum((SH.rank_block(v, 1) * ms).sum(dim=(1, 2)))

    ce = token_sum(nll) / denom
    zl = cfg.z_loss * token_sum(lse * lse) / denom
    al = cfg.aux_loss_weight * aux
    loss = ce + zl + al
    metrics = {"loss": loss, "ce": ce, "z_loss": zl, "aux_loss": al,
               "tokens": denom.expand(n)}
    return loss, metrics


# ---------------------------------------------------------------------------
# Decode state + single-token step (serving)
# ---------------------------------------------------------------------------

def _init_block_cache(cfg, block: Block, B: int, S_len: int,
                      device) -> dict:
    """One layer's empty decode cache: K/V for the attention kinds, the
    conv and SSM states for Mamba2, (C, n, m) for mLSTM, (c, n, h, m) for
    sLSTM (m at -1e30)."""
    dt = getattr(torch, cfg.cache_dtype)
    f32 = torch.float32

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    if block.kind in ATTN_KINDS:
        W = S_len if block.window is None else min(block.window, S_len)
        shape = (B, W, cfg.n_kv_heads, cfg.head_dim)
        return {"k": zeros(*shape, dtype=dt), "v": zeros(*shape, dtype=dt)}
    d = cfg.d_model
    if block.kind == "mamba2":
        din = cfg.ssm_expand * d
        K1 = cfg.ssm_conv - 1
        return {"conv": {"x": zeros(B, K1, din, dtype=dt),
                         "B": zeros(B, K1, cfg.ssm_state, dtype=dt),
                         "C": zeros(B, K1, cfg.ssm_state, dtype=dt)},
                "ssm": zeros(B, din // cfg.ssm_head_dim, cfg.ssm_head_dim,
                             cfg.ssm_state)}
    if block.kind == "mlstm":
        nh = cfg.n_heads
        hd = 2 * d // nh            # proj_factor 2: the inner dim's heads
        return {"C": zeros(B, nh, hd, hd), "n": zeros(B, nh, hd),
                "m": torch.full((B, nh), -1e30, dtype=f32, device=device)}
    if block.kind == "slstm":
        return {"c": zeros(B, d), "n": zeros(B, d), "h": zeros(B, d),
                "m": torch.full((B, d), -1e30, dtype=f32, device=device)}
    raise ValueError(block.kind)


def init_decode_state(cfg, B: int, S_len: int, device="cuda") -> dict:
    """Per-segment stacked caches mirroring ``params['segments']`` (a
    ``shared_attn`` firing's ``[1, ...]``)."""
    dev = resolve_device(device)
    segs = []
    for block, n in segments(cfg):
        one = _init_block_cache(cfg, block, B, S_len, dev)
        segs.append(T.tree_map(lambda x: x.expand(n, *x.shape).clone(), one))
    return {"segments": segs,
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _stack(caches):
    """Layer caches (trees alike) -> one tree of stacked leaves."""
    return T.tree_map(lambda *xs: torch.stack(xs), *caches)


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
    """One layer's decode step: (x', the layer's cache), a K/V cache
    written in place, a recurrent layer's new state."""
    if block.kind in _SUBLAYER:
        return _recurrent(p, cfg, block, x, fused_rmsnorm, cache)
    h, cache = _decode_attn(p, cfg, block, x, cache, pos)
    x = x + h
    return x + _ffn(p, cfg, block, fused_rmsnorm(x, p["ln2"],
                                                 cfg.norm_eps)), cache


def _ffn(p, cfg, block: Block, z):
    """A serving layer's feed-forward on the normed stream ``z``: the MLP,
    or for a ``moe`` block ``moe.moe`` on one rank (the capacity dispatch
    over the call's tokens, its drops included: in decode the batch's B
    tokens) with its aux dropped, as the reference's serving blocks do."""
    if block.kind == "moe":
        return M.moe(p["moe"], cfg, z)[0]
    return L.mlp(p["mlp"], cfg, z)


def _logits(params, cfg, x):
    x = fused_rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return L.dense(x, head)


def _is_frames(cfg, inputs) -> bool:
    """Float frames ``[B, T, frontend_dim]`` (the reference's test: a
    frontend model and 3-d inputs), not int tokens ``[B, T]``."""
    return cfg.frontend is not None and inputs.dim() == 3


def _embed(params, cfg, tokens):
    """The residual stream of ``tokens``: int tokens looked up in
    ``embed``, or a frontend model's frames through ``frontend_proj``."""
    if _is_frames(cfg, tokens):
        return L.dense(tokens, params["frontend_proj"])
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def decode_step(params, cfg, state, tokens, active=None):
    """tokens: [B,1] int (or [B,1,frontend_dim] frames).  One decode
    step, caches written in place.

    ``state["pos"]`` may be a 0-dim tensor (legacy fixed batch) or a
    ``[B]`` vector (continuous-batching slot pool; see ``serve.kvcache``).
    With an ``active`` mask (``[B]`` in {0,1}) only active slots advance
    their position — retired slots stay frozen until ``insert`` recycles
    them.

    Returns (logits [B,1,V], state)."""
    pos = state["pos"]
    x = _embed(params, cfg, tokens)
    segs = []
    for (block, n), seg_p, seg_c in zip(
            segments(cfg), params["segments"], state["segments"]):
        if block.kind == "shared_attn":
            x, _ = _decode_block(params["shared"], cfg, block, x,
                                 _layer(seg_c, 0), pos)
            segs.append(seg_c)
            continue
        caches = []
        for l in range(n):
            x, c = _decode_block(_layer(seg_p, l), cfg, block, x,
                                 _layer(seg_c, l), pos)
            caches.append(c)
        segs.append(seg_c if block.kind in ATTN_KINDS else _stack(caches))
    logits = _logits(params, cfg, x)
    adv = 1 if active is None else torch.as_tensor(
        active, device=pos.device).to(torch.int32)
    return logits, {"segments": segs, "pos": pos + adv}


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
    until decode overwrites it in place.  Recurrent layers carry their
    final states (Mamba2's conv state cast to ``cfg.cache_dtype``); they
    take no ``length``, as in the reference: their state would integrate
    the padding.
    """
    B, T = inputs.shape[:2]
    dev = inputs.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)
    if length is not None:
        length = _padded_length(cfg, length, dev)
    x = _embed(params, cfg, inputs)
    segs = []
    for (block, n), seg_p in zip(segments(cfg), params["segments"]):
        if block.kind == "shared_attn":
            x, c = _prefill_block(params["shared"], cfg, block, x, positions,
                                  length)
            segs.append(_stack([c]))
            continue
        caches = []
        for l in range(n):
            x, c = _prefill_block(_layer(seg_p, l), cfg, block, x, positions,
                                  length)
            caches.append(c)
        segs.append(_stack(caches))
    if length is None:
        xl = x[:, -1:]
        pos_out = torch.tensor(T, dtype=torch.int32, device=dev)
    else:
        last = torch.clamp(length - 1, 0, T - 1).long().reshape(1)
        xl = x.index_select(1, last)
        pos_out = length.reshape(())
    return _logits(params, cfg, xl), {"segments": segs, "pos": pos_out}


def _padded_length(cfg, length, dev):
    """A padded prefill's ``length`` as a 0-dim int32 tensor; raises for
    recurrent blocks, as the reference's prefill takes no length there."""
    bad = sorted({b.kind for b, _ in segments(cfg)} - set(ATTN_KINDS))
    if bad:
        raise NotImplementedError(
            f"padded prefill (length=...) unsupported for blocks {bad}: "
            f"recurrent state would integrate the padding")
    return torch.as_tensor(length, device=dev).to(torch.int32)


def _prefill_block(p, cfg, block: Block, x, positions, length=None):
    """Forward one block over the full sequence, returning its decode
    cache.  Q, K and V are computed once, for the attention and the cache
    both (the reference computes them twice, to the same values)."""
    if block.kind in _SUBLAYER:
        x, st = _recurrent(p, cfg, block, x, fused_rmsnorm)
        if block.kind == "mamba2":
            dt = getattr(torch, cfg.cache_dtype)
            st["conv"] = {k: v.to(dt) for k, v in st["conv"].items()}
        return x, st
    T = x.shape[1]
    B = x.shape[0]
    nh, hd = cfg.n_heads, cfg.head_dim
    q, k, v = L._qkv(p["attn"], cfg,
                     fused_rmsnorm(x, p["ln1"], cfg.norm_eps), positions)
    o = flash_attention(q, k, v, window=block.window, causal=True)
    x = x + L.dense(o.reshape(B, T, nh * hd).to(x.dtype), p["attn"]["wo"])
    x = x + _ffn(p, cfg, block, fused_rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, _page_cache(cfg, block, k, v, length)


def _page_cache(cfg, block: Block, k, v, length=None) -> dict:
    """A layer's decode cache from its prefill K/V ``[B, T, nkv, hd]``:
    the whole run, or under a window shorter than T the ring of the last
    ``window`` positions, slot ``q % window`` holding position q."""
    T = k.shape[1]
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
            s_idx = torch.arange(W, device=k.device)
            last = length - 1
            q_idx = last - torch.remainder(last - s_idx, W)
            ok = (q_idx >= 0)[None, :, None, None]
            qc = torch.clamp(q_idx, 0, T - 1).long()
            zero = torch.zeros((), dtype=k.dtype, device=k.device)
            ck = torch.where(ok, k.index_select(1, qc), zero).to(dt)
            cv = torch.where(ok, v.index_select(1, qc), zero).to(dt)
    else:
        ck, cv = k.to(dt), v.to(dt)
    return {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Serving under tensor parallelism
# ---------------------------------------------------------------------------
# The reference serves on a (data, model) mesh through GSPMD with its
# weights replicated (its serve CLI initialises them unsharded) and each
# KV leaf laid out by ``cache_specs``: the pages over DP, each page's
# slots over the model axis where its width divides it, else its KV
# heads, else whole (``sharding.KVLayout``).  Here the ranks run stacked
# and the weights are held once: each TP rank contracts a view of them
# (``sharding.rank_view``, ``Tensor.expand``).
#
# Prefill runs the TP forward's layers on the sequence-sharded stream:
# under megatron_sp each rank's heads go through the flash-attention
# kernel, the ranks flattened into its batch (one launch a layer); under
# pure_sp each rank's query chunks through ``layers._attn_seq_parallel``,
# as the reference's GSPMD prefill runs them (the flash kernel takes no
# query offset, so on the card only megatron_sp prefill launches it).
# Its K/V are gathered to the page's global layout, which
# ``serve.kvcache.write_slot`` splits over the ranks.  A MoE layer takes
# expert parallelism where ``moe.use_ep`` allows it (the reference's
# ``_moe_ep`` at ``moe.py:108``); frames enter through the replicated
# ``frontend_proj`` (``_frames_tp``).  A recurrent layer gathers the whole
# sequence and, split (``recurrent_split``), runs each rank's heads or
# units, its partial down projection reduced into the stream; else it runs
# once, on the whole sequence every rank holds alike, each rank keeping
# its own block.  Its state leaves in the global layout too: the ranks'
# heads or units concatenated (``join_state``).
#
# Decode runs the projections, the MLP and a MoE layer's dense path once
# on the replicated stream; each rank scores only the keys it holds, and
# a sequence-sharded page's partial softmax is combined over the ranks in
# float32 (flash decoding).  A split recurrent layer runs each rank's
# heads or units from its own state (``split_state``: ``[n, B, ...]``) and
# sums the ranks' partial outputs; a whole one runs once from its state,
# held once.  The fixed-batch loop (a 0-dim ``pos``) writes K/V as
# ``decode_step``'s scalar path does: clamped into the page's last slot
# past its end, the reference's ``dynamic_update_slice``.
# Logits leave both as the ranks' vocab blocks ``[n, B, 1, ceil(V/n)]``,
# the last zero-padded past V, which the sampler gathers.

#: the per-rank dim of each layer weight's Megatron block (``[d_in,
#: d_out]``): the column block of the input projections, the row block of
#: the output ones
_SERVE_DIM = {"wq": 1, "wk": 1, "wv": 1, "wi": 1, "wg": 1, "wo": 0}

#: per recurrent block, the dim of its heads or units in each decode state
#: leaf of one layer that splits over the TP ranks (``[B, ...]``); a leaf
#: not named (Mamba2's B and C conv states) every rank holds whole
STATE_DIM = {"mamba2": {"x": 2, "ssm": 1},
             "mlstm": {"C": 1, "n": 1, "m": 1},
             "slstm": {"c": 1, "n": 1, "h": 1, "m": 1}}


def _state_map(kind: str, state, fn):
    """``fn(leaf, dim)`` over one layer's (or a segment's) recurrent state,
    ``dim`` the leaf's ``STATE_DIM`` entry or None."""
    return T.unflatten(state, [fn(x, STATE_DIM[kind].get(path[-1]))
                               for path, x in T.flatten_with_path(state)])


def split_state(kind: str, state, n: int, lead: int = 0):
    """A recurrent state in its global layout (leaves ``[*lead, B,
    ...]``, ``lead`` leading dims such as a segment's layers) -> the TP
    ranks' ``[*lead, n, B, ...]``: each rank its block of the split dim,
    or its own copy of a leaf held whole."""
    def one(x, d):
        if d is None:
            return x.unsqueeze(lead).expand(
                x.shape[:lead] + (n,) + x.shape[lead:]).clone()
        return torch.stack(x.chunk(n, dim=lead + d), dim=lead)
    return _state_map(kind, state, one)


def join_state(kind: str, state, lead: int = 0):
    """Inverse of :func:`split_state`: the ranks' blocks concatenated,
    rank 0's copy of a leaf held whole."""
    def one(x, d):
        if d is None:
            return x.select(lead, 0)
        return torch.cat(x.unbind(lead), dim=lead + d)
    return _state_map(kind, state, one)


def _rank_layer(p, cfg, tp: _TP):
    """Layer ``p``'s attention and MLP weights, held once, as the TP
    ranks contract them: views ``[n, ...]`` of each weight's Megatron
    block under megatron_sp (K/V whole under the GQA rule), of the whole
    weight under pure_sp."""
    n = tp.n
    kv_whole = cfg.n_kv_heads % n != 0
    out = {}
    for sub in ("attn", "mlp"):
        if sub not in p:
            continue
        out[sub] = {}
        for k, w in p[sub].items():
            if tp.strat == "megatron_sp" and k in _SERVE_DIM and not (
                    kv_whole and sub == "attn" and k in ("wk", "wv")):
                out[sub][k] = SH.rank_view(w, _SERVE_DIM[k], n)
            else:
                out[sub][k] = w.expand((n,) + tuple(w.shape))
    return out


def _rank_recurrent(sub, kind: str, n: int):
    """A recurrent sublayer's weights, held once, as split TP ranks read
    them: views ``[n, ...]`` of each leaf's block of its heads or units
    (``_SPLIT_DIM``), of the whole leaf where every rank reads it."""
    dims = _SPLIT_DIM[_SUBLAYER[kind]]
    return {k: SH.rank_view(w, dims[k], n) if k in dims
            else w.expand((n,) + tuple(w.shape)) for k, w in sub.items()}


def _vocab_blocks(logits, n: int):
    """``[..., V]`` logits -> the ranks' vocab blocks ``[n, ..., Vl]``,
    ``Vl = ceil(V / n)``, zero past V (the logits of ``forward_tp``'s
    padded vocab rows)."""
    pad = -logits.shape[-1] % n
    if pad:
        logits = torch.nn.functional.pad(logits, (0, pad))
    return logits.unflatten(-1, (n, logits.shape[-1] // n)).movedim(-2, 0)


def vocab_logits(blocks, V: int):
    """The ranks' vocab blocks ``[n, ..., Vl]`` -> the logits ``[...,
    V]`` (the all-gather of the sampler)."""
    return blocks.movedim(0, -2).flatten(-2)[..., :V]


def _ffn_tp(p, rp, cfg, block: Block, y, tp: _TP):
    """A prefill layer's feed-forward on the normed stream ``y``: the MLP
    over the rank views ``rp``, or a MoE layer's ``moe.moe`` over the
    ranks, its aux dropped (expert parallelism on each rank's view of the
    expert blocks where ``moe.use_ep`` allows, else every rank's dense
    path on the whole blocks)."""
    if block.kind != "moe":
        return _mlp_tp(rp["mlp"], cfg, y, tp)
    n = tp.n
    ep = tp.sp and M.use_ep(cfg, n, y.shape[2] * n)
    mp = {k: SH.rank_view(w, 0, n) if ep and k != "router"
          else w.expand((n,) + tuple(w.shape)) for k, w in p["moe"].items()}
    return M.moe(mp, cfg, y, n, tp.sp)[0]


def _prefill_recurrent_tp(p, cfg, block: Block, x, tp: _TP):
    """:func:`_prefill_block`'s recurrent layer on the stacked TP ranks:
    (x', the layer's final state in its global layout)."""
    n = tp.n
    eps = cfg.norm_eps
    fn = getattr(S, block.kind)
    sub = p[_SUBLAYER[block.kind]]
    h = tp.gather(fused_rmsnorm(x, p["ln1"], eps))            # [n,B,T,d]
    if recurrent_split(cfg, block.kind, n):
        out, st = fn(_rank_recurrent(sub, block.kind, n), cfg,
                     h.flatten(0, 1), return_state=True,
                     tp=S.Ranks(n, True))
        x = x + tp.reduce(out.unflatten(0, (n, -1)))
        st = join_state(block.kind, T.tree_map(
            lambda v: v.unflatten(0, (n, -1)), st))
    else:
        out, st = fn(sub, cfg, h[0], return_state=True, norm=fused_rmsnorm)
        x = x + (SH.seq_shard(out, n) if tp.sp else out)
    if "mlp" in p:          # a Mamba2 block outside zamba
        x = x + _mlp_tp(_rank_layer(p, cfg, tp)["mlp"], cfg,
                        fused_rmsnorm(x, p["ln2"], eps), tp)
    if block.kind == "mamba2":
        dt = getattr(torch, cfg.cache_dtype)
        st["conv"] = {k: v.to(dt) for k, v in st["conv"].items()}
    return x, st


def _prefill_block_tp(p, cfg, block: Block, x, pos, tp: _TP, length):
    """:func:`_prefill_block` on the stacked TP ranks: ``x`` is the
    residual stream (``[n, B, T/n, d]``, or ``[n, B, T, d]`` when T does
    not divide n); the cache comes back in the page's global layout."""
    if block.kind in _SUBLAYER:
        return _prefill_recurrent_tp(p, cfg, block, x, tp)
    n = tp.n
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T_ = pos.shape[0]
    rp = _rank_layer(p, cfg, tp)
    q, k, v = _qkv_tp(rp["attn"], cfg,
                      fused_rmsnorm(x, p["ln1"], cfg.norm_eps), pos, tp)
    if tp.strat == "megatron_sp":
        kf, vf = k, v
        if nkv % n:     # the GQA rule: K/V whole, the heads split now
            g = nh // nkv
            kf = SH.rank_block(k.repeat_interleave(g, dim=3), 2)
            vf = SH.rank_block(v.repeat_interleave(g, dim=3), 2)
            kg, vg = k[0], v[0]
        else:
            kg, vg = stacked.all_gather(k, 2)[0], stacked.all_gather(v, 2)[0]
        o = flash_attention(q.flatten(0, 1), kf.flatten(0, 1),
                            vf.flatten(0, 1), window=block.window,
                            causal=True)
        o = o.reshape(n, q.shape[1], T_, (nh // n) * hd).to(x.dtype)
        x = x + tp.reduce(L.dense_tp(o, rp["attn"]["wo"]))
    else:
        kw, vw = SH.seq_gather(k), SH.seq_gather(v)
        o = _seq_parallel_attn(cfg, block, q, kw, vw, pos, n)
        x = x + L.dense_tp(o.to(x.dtype), rp["attn"]["wo"])
        kg, vg = kw[0], vw[0]
    x = x + _ffn_tp(p, rp, cfg, block,
                    fused_rmsnorm(x, p["ln2"], cfg.norm_eps), tp)
    return x, _page_cache(cfg, block, kg, vg, length)


def prefill_tp(params, cfg, inputs, n_model: int, length=None):
    """:func:`prefill` over ``n_model`` stacked TP ranks, ``params`` the
    global tree held once; ``inputs`` int tokens ``[B, T]`` or a frontend
    model's frames ``[B, T, F]``.  Returns the last-token logits as vocab
    blocks ``[n, B, 1, ceil(V/n)]`` and the decode state in its global
    layout (every rank's K/V gathered, a split recurrent state's heads or
    units joined).  pure_sp with T % n != 0 falls through to the single
    path, as the reference's attention does; every rank would run it on
    the same values."""
    B, T_ = inputs.shape[:2]
    tp = _TP(cfg, n_model, T_)
    if tp.strat == "pure_sp" and not tp.sp:
        logits, state = prefill(params, cfg, inputs, length)
        return _vocab_blocks(logits, n_model), state
    dev = inputs.device
    pos = torch.arange(T_, dtype=torch.int32, device=dev)
    if length is not None:
        length = _padded_length(cfg, length, dev)
    if _is_frames(cfg, inputs):
        W = params["frontend_proj"]
        x = _frames_tp(W.expand((n_model,) + tuple(W.shape)), inputs, tp)
    else:
        x = _embed(params, cfg, inputs)
        x = SH.seq_shard(x, n_model) if tp.sp else \
            x.expand((n_model,) + tuple(x.shape))
    segs = []
    for (block, n), seg_p in zip(segments(cfg), params["segments"]):
        if block.kind == "shared_attn":
            x, c = _prefill_block_tp(params["shared"], cfg, block, x, pos,
                                     tp, length)
            segs.append(_stack([c]))
            continue
        caches = []
        for l in range(n):
            x, c = _prefill_block_tp(_layer(seg_p, l), cfg, block, x, pos,
                                     tp, length)
            caches.append(c)
        segs.append(_stack(caches))
    x = tp.gather(x)[0]                                  # [B, T, d]
    if length is None:
        xl = x[:, -1:]
        pos_out = torch.tensor(T_, dtype=torch.int32, device=dev)
    else:
        last = torch.clamp(length - 1, 0, T_ - 1).long().reshape(1)
        xl = x.index_select(1, last)
        pos_out = length.reshape(())
    return (_vocab_blocks(_logits(params, cfg, xl), n_model),
            {"segments": segs, "pos": pos_out})


def _decode_attn_tp(p, cfg, block: Block, x, cache, pos, lay,
                    clamp: bool = False):
    """:func:`_decode_attn` over a KV pool laid out by ``lay``
    (``sharding.KVLayout``; ``cache`` leaves ``[rows, B_local, W_local,
    nkv_local, hd]``), ``pos [B]``.  Q, K and V come from the replicated
    stream ``x [B, 1, d]``; the new K/V land on the rank whose shard holds
    slot ``pos % W`` (``pos``), a slot past its page dropping its write
    (``clamp``: landing in the page's last slot, the fixed-batch loop's
    write).  Each rank scores its own keys, their positions decoded from
    global slot indices.  A sequence-sharded page combines the ranks'
    partial softmax in float32; a head-sharded one gathers the ranks'
    heads."""
    ck, cv = cache["k"], cache["v"]
    _, Bl, Wl, nkvl, hd = ck.shape
    rdp, rt = lay.rdp, lay.rtp
    W = lay.width
    B = x.shape[0]
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    g = nh // nkv
    dev = x.device
    ring = block.window is not None and block.window <= W
    slot = torch.remainder(pos, W) if ring else pos
    q, k, v = L._qkv(p["attn"], cfg,
                     fused_rmsnorm(x, p["ln1"], cfg.norm_eps),
                     pos[:, None].to(torch.int32))
    b = torch.arange(B, device=dev)
    r, bl = b // Bl, b % Bl                 # each page's DP rank and row
    ok = torch.ones_like(slot, dtype=torch.bool) if clamp else slot < W
    sc = torch.clamp(slot, max=W - 1).long()
    heads = lay.kv == "heads"
    if heads:       # every rank writes its heads
        idx = ((r * rt)[:, None] + torch.arange(rt, device=dev),
               bl[:, None], sc[:, None])
        shape = (B, rt, nkvl, hd)
    else:           # the rank holding the slot (one row when whole)
        idx = (r * rt + sc // Wl, bl, sc % Wl)
        shape = (B, nkv, hd)
    okb = ok.view((B,) + (1,) * (len(shape) - 1))
    for c, new in ((ck, k), (cv, v)):
        c[idx] = torch.where(okb, new[:, 0].reshape(shape).to(c.dtype),
                             c[idx])
    qg = q.reshape(B, nkv, g, hd).to(torch.float32)
    if heads:
        qr = qg.view(rdp, Bl, rt, nkvl, g, hd).transpose(1, 2)
        kpos = torch.arange(Wl, device=dev).view(1, 1, 1, Wl)
    else:
        qr = qg.view(rdp, 1, Bl, nkv, g, hd).expand(rdp, rt, Bl, nkv, g, hd)
        kpos = (torch.arange(rt, device=dev)[:, None] * Wl
                + torch.arange(Wl, device=dev)).view(1, rt, 1, Wl)
    posb, slotb = pos.view(rdp, 1, Bl, 1), slot.view(rdp, 1, Bl, 1)
    if ring:
        # ring slots hold positions pos-W+1..pos; valid if <= pos and fresh
        abs_pos = posb - torch.remainder(slotb - kpos, W)
        valid = (abs_pos >= 0) & (abs_pos <= posb) & (
            posb - abs_pos < block.window)
    else:
        valid = kpos <= posb
        if block.window is not None:
            valid &= (posb - kpos) < block.window
    kc = ck.view(rdp, rt, Bl, Wl, nkvl, hd).to(torch.float32)
    vc = cv.view(rdp, rt, Bl, Wl, nkvl, hd).to(torch.float32)
    s = torch.einsum("rtbkgh,rtbskh->rtbkgs", qr, kc) / math.sqrt(hd)
    vmask = valid[:, :, :, None, None, :]
    if heads:
        s = torch.where(vmask, s, torch.full((), -math.inf, device=dev))
        o = torch.einsum("rtbkgs,rtbskh->rtbkgh", torch.softmax(s, dim=-1),
                         vc)
        # the ranks' heads gathered before wo
        o = stacked.all_gather(o.transpose(0, 1), 2)[0]
    else:
        e, m, d = L._masked_tile(s, vmask)
        o = _combine_partial(torch.einsum("rtbkgs,rtbskh->rtbkgh", e, vc),
                             m, d, valid.any(dim=-1))
    o = o.reshape(B, 1, nh * hd).to(x.dtype)
    return L.dense(o, p["attn"]["wo"])


def _combine_partial(o, m, d, has):
    """The flash-decoding combine over the TP ranks (dim 1) of the partial
    softmax ``o [rdp, rt, B, nkv, g, hd]``, its row max ``m`` and sum
    ``d`` (``[rdp, rt, B, nkv, g]``), in float32: with ``M`` the ranks'
    largest max (an all-gather, then ``amax``), ``o = sum_t o_t
    e^(m_t - M) / sum_t d_t e^(m_t - M)`` (two psums).  A rank with no
    valid key (``has [rdp, rt, B]`` false) contributes zero."""
    ninf = torch.full((), -math.inf, device=o.device)
    m = torch.where(has[..., None, None], m, ninf).transpose(0, 1)
    M = torch.amax(stacked.all_gather(m.unsqueeze(-1), -1), dim=-1)
    f = torch.where(torch.isfinite(m),
                    torch.exp(m - torch.where(torch.isfinite(M), M,
                                              torch.zeros_like(M))),
                    torch.zeros_like(m))
    num = stacked.psum(o.transpose(0, 1) * f[..., None])
    den = stacked.psum(d.transpose(0, 1) * f)
    return (num / den[..., None])[0]


def _decode_recurrent_tp(p, cfg, block: Block, x, state, lay):
    """A recurrent layer's decode step over the TP ranks on the replicated
    stream ``x [B, 1, d]``: split (``lay.kv == "heads"``), each rank its
    heads or units from its own state ``[n, B, ...]``, the ranks' partial
    outputs summed (a psum); whole, once from the state held once, as
    :func:`decode_step`.  Returns (x', the new state)."""
    if lay.kv != "heads":
        return _recurrent(p, cfg, block, x, fused_rmsnorm, state)
    n = lay.n_tp
    h = fused_rmsnorm(x, p["ln1"], cfg.norm_eps)
    out, st = getattr(S, block.kind)(
        _rank_recurrent(p[_SUBLAYER[block.kind]], block.kind, n), cfg,
        h.expand((n,) + tuple(h.shape)).flatten(0, 1),
        state=T.tree_map(lambda v: v.flatten(0, 1), state),
        return_state=True, tp=S.Ranks(n, True))
    x = x + stacked.psum(out.unflatten(0, (n, -1)))[0]
    if "mlp" in p:          # a Mamba2 block outside zamba
        x = x + L.mlp(p["mlp"], cfg, fused_rmsnorm(x, p["ln2"],
                                                   cfg.norm_eps))
    return x, T.tree_map(lambda v: v.unflatten(0, (n, -1)), st)


def decode_step_tp(params, cfg, state, tokens, layout, active=None):
    """:func:`decode_step` over a state laid out per segment by ``layout``
    (``sharding.KVLayout``s; a recurrent segment's states split over the
    ranks when its ``kv`` is ``"heads"``, held once when ``"whole"``).
    ``state["pos"]`` is ``[B]`` (the pool) or 0-dim (the fixed-batch
    loop, its K/V writes clamped as :func:`decode_step`'s).  ``tokens``:
    ``[B, 1]`` int, or ``[B, 1, frontend_dim]`` frames.  Returns the
    logits as vocab blocks ``[n_tp, B, 1, ceil(V/n_tp)]`` and the state,
    its caches written in place."""
    pos = state["pos"]
    x = _embed(params, cfg, tokens)
    fixed = pos.dim() == 0
    posv = pos.expand(x.shape[0]).contiguous() if fixed else pos
    segs = []
    for (block, n), seg_p, seg_c, lay in zip(
            segments(cfg), params["segments"], state["segments"], layout):
        shared = block.kind == "shared_attn"
        caches = []
        for l in range(n):
            p = params["shared"] if shared else _layer(seg_p, l)
            if block.kind in _SUBLAYER:
                x, c = _decode_recurrent_tp(p, cfg, block, x,
                                            _layer(seg_c, l), lay)
                caches.append(c)
                continue
            x = x + _decode_attn_tp(p, cfg, block, x, _layer(seg_c, l),
                                    posv, lay, clamp=fixed)
            x = x + _ffn(p, cfg, block, fused_rmsnorm(x, p["ln2"],
                                                      cfg.norm_eps))
        segs.append(_stack(caches) if caches else seg_c)
    logits = _vocab_blocks(_logits(params, cfg, x), layout[0].n_tp)
    adv = 1 if active is None else torch.as_tensor(
        active, device=pos.device).to(torch.int32)
    return logits, {"segments": segs, "pos": pos + adv}
