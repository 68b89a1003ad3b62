"""Parameter partition specs over the model axis, and the stacked
tensor-parallel layout they define.

Port of ``repro.models.sharding``.  The reference writes specs and lets
GSPMD lay the model axis out; here the ``n_model`` TP ranks of one DP
rank run stacked on one device, so the layouts are explicit:

  * ``shard_params`` turns a global parameter tree into leaves stacked
    ``[n_model, ...]``: rank t holds block t along the dim
    ``param_specs`` marks ``"model"`` (a leaf without one, or whose dim
    does not divide by ``n_model``, is held whole by every rank — where
    the reference's GSPMD would pad, the port replicates; only the
    layout differs);
  * ``seq_shard`` / ``seq_gather`` / ``seq_reduce_scatter`` move the
    residual stream ``[B, T, d]`` between its global form, the
    sequence-sharded ``[n, B, T/n, d]`` and the gathered
    ``[n, B, T, d]``, through the rank-dim built-ins of
    ``collectives.stacked`` (GSPMD's all-gather and reduce-scatter);
  * ``rank_block`` is the head and ffn split: each rank's block of a
    value it holds whole; ``rank_view`` takes the same blocks of one
    tensor held once (serving's whole weights) as a view;
  * ``KVLayout`` is one segment's serving KV pool over the DP and TP
    ranks (``serve.engine.cache_layout`` picks it by the reference's
    ``cache_specs`` rule).

``n_model`` is passed explicitly (the reference's ``set_model_parallel``
global has no counterpart).  A spec is a tuple with ``"model"`` or
``None`` per dim.  The ZeRO layout (``train.zero``) skips every dim the
specs mark, whatever ``n_model`` is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as T
from repro_torch.collectives import stacked

MODEL_AXIS = "model"


def strategy(cfg, n_model: int = 1) -> str:
    """Per-arch layer parallelism strategy over a model axis of
    ``n_model``: ``single`` (no TP), ``megatron_sp`` or ``pure_sp``."""
    if n_model <= 1:
        return "single"
    if cfg.n_heads % n_model == 0 and cfg.d_model >= 1024:
        return "megatron_sp"
    return "pure_sp"


_RULES: Dict[Tuple[str, int], Tuple] = {
    # embeddings / head
    ("embed", 2): (MODEL_AXIS, None),        # vocab-sharded
    ("lm_head", 2): (None, MODEL_AXIS),
    # attention
    ("wq", 2): (None, MODEL_AXIS),
    ("wk", 2): (None, MODEL_AXIS),
    ("wv", 2): (None, MODEL_AXIS),
    ("wo", 2): (MODEL_AXIS, None),           # attn out [H*hd, d] / mlp out [F, d]
    # mlp
    ("wi", 2): (None, MODEL_AXIS),
    ("wg", 2): (None, MODEL_AXIS),
    # moe — expert-block leaves [E*ep_blocks, d, ffb]
    ("router", 2): (None, None),
    ("wi", 3): (MODEL_AXIS, None, None),
    ("wg", 3): (MODEL_AXIS, None, None),
    ("wo", 3): (MODEL_AXIS, None, None),
    # mamba2
    ("m_z", 2): (None, MODEL_AXIS),
    ("m_x", 2): (None, MODEL_AXIS),
    ("m_B", 2): (None, None),
    ("m_C", 2): (None, None),
    ("m_dt", 2): (None, None),
    ("conv_x", 2): (None, MODEL_AXIS),
    ("conv_B", 2): (None, None),
    ("conv_C", 2): (None, None),
    ("A_log", 1): (MODEL_AXIS,),
    ("D", 1): (MODEL_AXIS,),
    ("dt_bias", 1): (MODEL_AXIS,),
    ("out_proj", 2): (MODEL_AXIS, None),
    # mLSTM
    ("wup", 2): (None, MODEL_AXIS),
    ("wgate", 2): (None, MODEL_AXIS),
    ("down", 2): (MODEL_AXIS, None),
    # sLSTM
    ("wz", 2): (None, MODEL_AXIS),
    ("ri", 1): (MODEL_AXIS,), ("rf", 1): (MODEL_AXIS,),
    ("rz", 1): (MODEL_AXIS,), ("ro", 1): (MODEL_AXIS,),
}

#: leaf names that can appear scan-stacked (leading period/layer dim)
_NORM_NAMES = {"norm", "norm2", "final_norm", "ln1", "ln2", "ln3",
               "q_norm", "k_norm"}


def param_specs(cfg, params: Any, n_model: int = 1) -> Any:
    """Spec tuple tree mirroring ``params`` (leaves need ``.ndim``).

    Name+ndim matched; stacked leading dims shift specs right by one.
    Unmatched leaves (gates, norms, biases) are replicated.  As in the
    reference, the unshifted rule is tried first, so a dense segment's
    ``wi`` / ``wg`` / ``wo`` ``[n_layers, ., .]`` take the 3-d MoE rules
    and mark their layer dim.
    """
    strat = strategy(cfg, n_model)
    pure_sp_keep = {"embed", "lm_head"}

    def spec_for(path, leaf):
        names = [str(k) for k in path]
        name = names[-1] if names else ""
        if name in _NORM_NAMES:
            return (None,) * leaf.ndim
        if strat == "pure_sp" and name not in pure_sp_keep:
            return (None,) * leaf.ndim
        if strat == "megatron_sp" and name in ("wk", "wv") and \
                cfg.n_kv_heads % max(n_model, 1) != 0:
            nd = leaf.ndim - (1 if leaf.ndim == 3 else 0)
            if nd == 2:
                return (None,) * leaf.ndim
        for lead in (0, 1):
            key = (name, leaf.ndim - lead)
            if key in _RULES:
                return ((None,) * lead) + tuple(_RULES[key])
        return (None,) * leaf.ndim

    return T.map_with_path(spec_for, params)


# ---------------------------------------------------------------------------
# The stacked TP layout: [n_model, ...] per leaf
# ---------------------------------------------------------------------------

def model_dim(spec, shape, n_model: int) -> int:
    """The dim a leaf of ``shape`` is stacked on over ``n_model`` ranks:
    the one ``spec`` marks ``"model"`` if it divides by ``n_model``, else
    -1 (every rank holds the leaf whole)."""
    for d, s in enumerate(spec):
        if s == MODEL_AXIS and shape[d] % n_model == 0:
            return d
    return -1


def model_dims(cfg, params: Any, n_model: int) -> Any:
    """Tree of :func:`model_dim` per leaf of the global ``params``."""
    specs = param_specs(cfg, params, n_model)
    return T.tree_map(lambda x, s: model_dim(s, tuple(x.shape), n_model),
                      params, specs)


def local_shape(shape, md: int, n_model: int) -> Tuple[int, ...]:
    """One TP rank's shape of a leaf of global ``shape``."""
    out = list(shape)
    if md >= 0:
        out[md] //= n_model
    return tuple(out)


def split_leaf(x: torch.Tensor, md: int, n_model: int) -> torch.Tensor:
    """One global tensor -> ``[n_model, ...]``: rank t's block t along
    ``md``, or (``md < 0``) each rank its own copy of the whole."""
    if md < 0:
        return x.unsqueeze(0).expand((n_model,) + tuple(x.shape)).clone()
    return torch.stack(x.chunk(n_model, dim=md))


def join_leaf(xs: torch.Tensor, md: int, what: str = "") -> torch.Tensor:
    """Inverse of :func:`split_leaf`: the shards concatenated along
    ``md``, or rank 0's copy, the others checked equal (not on
    ``meta``)."""
    if md >= 0:
        return torch.cat(list(xs), dim=md)
    if xs.device.type != "meta":
        for t in range(1, xs.shape[0]):
            if not torch.equal(xs[t], xs[0]):
                raise ValueError(f"{what}: TP rank {t}'s copy differs "
                                 f"from rank 0's")
    return xs[0]


def shard_params(cfg, tree: Any, n_model: int) -> Any:
    """A global tree -> each leaf stacked ``[n_model, ...]``
    (:func:`split_leaf` along :func:`model_dim`)."""
    return T.tree_map(lambda x, md: split_leaf(x, md, n_model), tree,
                      model_dims(cfg, tree, n_model))


def unshard_params(cfg, tree: Any, n_model: int, shapes: Any) -> Any:
    """Inverse of :func:`shard_params`; ``shapes``: the global tree (or
    its ``meta`` shapes, e.g. ``transformer.param_shapes``), which decides
    each leaf's model dim."""
    return T.unflatten(tree, [
        join_leaf(x, md, T.keystr(path)) for (path, x), md in zip(
            T.flatten_with_path(tree),
            T.flatten(model_dims(cfg, shapes, n_model)))])


def seq_shard(x: torch.Tensor, n_model: int, dim: int = 1) -> torch.Tensor:
    """A global tensor (``[B, T, ...]``) -> ``[n_model, ...]``, rank t
    holding block t of ``dim`` (the sequence)."""
    return torch.stack(x.chunk(n_model, dim=dim))


def seq_gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """All-gather over the TP ranks of ``x [n, ...]`` along per-rank dim
    ``dim``: the sequence-sharded residual stream to the whole sequence
    on every rank.  Its gradient is a reduce-scatter."""
    return stacked.all_gather(x, dim)


def seq_reduce_scatter(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Reduce-scatter over the TP ranks of the partial sums ``x [n, ...]``
    along per-rank dim ``dim``: a row-parallel product's partial outputs
    to the sequence-sharded residual stream.  Its gradient is an
    all-gather."""
    return stacked.psum_scatter(x, dim)


def rank_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x [n, ...]``, which every rank holds whole, -> rank t's block t
    of per-rank dim ``dim`` (the head or ffn split of a replicated value;
    no communication)."""
    n = x.shape[0]
    k = x.shape[dim + 1] // n
    if k * n != x.shape[dim + 1]:
        raise ValueError(f"dim {dim} of {tuple(x.shape[1:])} does not split "
                         f"over {n} ranks")
    return torch.stack([x[t].narrow(dim, t * k, k) for t in range(n)])


def rank_view(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x``, held once, -> ``[n, ...]`` whose rank t is block t of
    ``dim``: :func:`rank_block` of ``x`` on every rank, as a view (no
    copy)."""
    k = x.shape[dim] // n
    if k * n != x.shape[dim]:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    return x.unflatten(dim, (n, k)).movedim(dim, 0)


#: how a KV leaf splits over the TP ranks: its sequence (page width), its
#: KV heads, or not at all
KV_SPLITS = ("seq", "heads", "whole")


@dataclass(frozen=True)
class KVLayout:
    """One segment's KV pool over ``n_dp`` DP ranks of ``n_tp`` TP ranks,
    stacked on one device.

    A leaf is ``[n_layers, rows, B_local, W_local, nkv_local, hd]``, row
    ``r * rtp + t`` holding DP rank r's pages (all ``B`` of them when
    ``batch_split`` is false) and TP rank t's shard: ``W / n_tp`` slots of
    each page (``"seq"``, slot ``s`` on rank ``s // (W / n_tp)``), or
    ``nkv / n_tp`` KV heads (``"heads"``).  A leaf that does not split
    (``"whole"``, or the pages over DP) is held once, not once a rank.  A
    recurrent segment of the fixed-batch loop uses ``kv`` alone: its
    states split over the TP ranks by heads or units (``"heads"``, leaves
    ``[n_layers, n_tp, B, ...]``) or held once (``"whole"``)."""
    n_dp: int
    n_tp: int
    batch_split: bool
    kv: str
    width: int

    def __post_init__(self):
        if self.kv not in KV_SPLITS:
            raise ValueError(f"unknown KV split {self.kv!r}")

    @property
    def rdp(self) -> int:
        """DP rows: ``n_dp`` when the pages split over DP, else 1."""
        return self.n_dp if self.batch_split else 1

    @property
    def rtp(self) -> int:
        """TP rows: ``n_tp`` unless the leaf is held whole."""
        return 1 if self.kv == "whole" else self.n_tp

    @property
    def rows(self) -> int:
        return self.rdp * self.rtp

    def local_shape(self, B: int, nkv: int) -> Tuple[int, int, int]:
        """``(B_local, W_local, nkv_local)`` of a pool of ``B`` pages."""
        return (B // self.rdp,
                self.width // self.n_tp if self.kv == "seq" else self.width,
                nkv // self.n_tp if self.kv == "heads" else nkv)
