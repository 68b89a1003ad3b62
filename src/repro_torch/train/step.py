"""The training step: DP ranks stacked on one device, Bine gradient
collectives, ZeRO-1 AdamW.

Port of ``repro.train.step``.  The reference runs the step body under
``shard_map`` on p devices; here the p ranks run on one device:

  * every DP rank holds its own parameters — ``params`` is a list of
    ``n_dp`` trees — and runs forward and backward on its own batch shard,
    one rank after another;
  * gradients, optimizer shards, error-feedback residuals and collective
    buffers are stacked ``[p, ...]``, and every collective runs over that
    rank axis: ``collectives.stacked`` for ``bine`` / ``recdoub`` /
    ``ring``, its rank-dim built-ins for ``xla``,
    ``kernels.collectives.ops`` — the CUDA step kernels — for
    ``pallas_fused``, and ``auto`` resolved per call site through the
    packaged decision tables (``repro_torch.topology``).

Two DP axes: ``TrainConfig.dp_axes=("pod", "data")`` with the axes' sizes
``(pods, data)`` given where the reference gives a mesh.  The ranks are
stacked row-major, ``r = pod * data + d``, as the reference flattens the
tuple axis, so every backend but ``bine_hier`` runs over the flattened
rank set, as the reference's tuple-axis calls do.  ``bine_hier`` runs the
Sec. 6.2 hierarchy: reduce-scatter over ``data`` first (the big messages
stay inside a pod), then over ``pod``; the allgather the other way.  Rank
``(pod, d)`` then owns flat block ``d * pods + pod``: ``opt_dp_order``
says so, and the optimizer shards are cut that way.  On one axis
``bine_hier`` is flat ``bine``, as in the reference's bucketed path (its
per-leaf path raises ``KeyError`` there).

Tensor parallelism (a model axis of ``tp > 1``): the reference's step is
manual over the DP axes and leaves the model axis to GSPMD.  Here each DP
rank's tree is stacked over its TP ranks (``models.sharding``), its
forward and backward run the whole TP group at once (the TP collectives
sit mid-forward), a leaf every TP rank holds whole has its gradient
summed over them (GSPMD's implicit reduction), and every DP collective
runs over the DP ranks within each TP column (:class:`Ranks`): the
bucket plan is the reference's, over the global leaves, and TP rank t
packs its shards into column t (``buckets.local_plan``), so each element
is reduced in its reference block.  An int8-wire bucket is coded whole
on every TP rank instead, as the reference's compiled step does: the
codec's chunks are then the reference's.  Optimizer shards are cut from
each TP rank's weight shard; the grad norm counts every element once.

The global layout (``to_global`` / ``from_global``): a checkpoint holds
the logical arrays, as the reference's does (its arrays are global):
``{"params": one rank's tree, "state": {"opt": each leaf whole, "step",
"ef": [n_dp, L] residuals}}``.  Stacked rank r's optimizer shard is block
``shard_owner[r]`` of the global leaf along its zero dim, so the two
functions invert each other for any DP shape, and a restore at another
``n_dp`` re-slices by that ``n_dp``'s ZeRO layout.

The bucketed step: pack each bucket's gradients (f32, bf16 or int8 wire,
pre-scaled as the reference does), one reduce-scatter per bucket (int8
buckets through error feedback), ONE small allreduce of grad-norm and
metrics, clipping, sharded AdamW on per-leaf views, one allgather per
bucket, unpack.  ``bucket_bytes=0`` (or one rank) takes the per-leaf
dim-general path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.collectives import compression as comp
from repro_torch.collectives import stacked
from repro_torch.collectives.api import executable_at
from repro_torch.kernels.collectives import ops as fused
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import (AdamWConfig, adamw_init_leaf,
                                     adamw_update_leaf, lr_at)
from repro_torch.train import buckets, zero

#: wire dtypes TrainConfig accepts — "auto" resolves per bucket via the
#: joint (backend, wire) decision table
WIRE_DTYPES = ("float32", "bfloat16", "int8", "auto")

#: backends this port runs
BACKENDS = ("bine", "recdoub", "ring", "xla", "bine_hier", "pallas_fused",
            "auto")

#: backends with an int8 wire-codec path
_CODEC_BACKENDS = ("bine", "recdoub", "pallas_fused")


@dataclass(frozen=True)
class TrainConfig:
    """The reference's config less what the port does not run yet: at most
    two DP axes (stacked on one device); the model axis's size comes with
    the step's ``tp`` argument, as the DP axes' come with ``dp``."""
    backend: str = "bine"            # bine | recdoub | ring | xla | bine_hier
    #                                # | pallas_fused | auto
    #: the DP axes, outermost first; their sizes come with the step's
    #: ``dp`` argument
    dp_axes: Tuple[str, ...] = ("data",)
    accum_steps: int = 1
    clip_norm: float = 1.0
    #: gradient/param wire: float32 | bfloat16 (cast) | int8 (pow2-scale
    #: wire codec + error feedback, bucketed path only) | auto (per-bucket
    #: joint (backend, wire) table lookup)
    wire_dtype: str = "float32"
    adamw: AdamWConfig = AdamWConfig()
    #: decision-table preset for backend="auto", wire_dtype="auto" and
    #: bucket_bytes=-1
    topology: str = "tpu_multipod"
    #: table provenance: "analytic" (the packaged tables) or "measured" (a
    #: tuner's measured table merged over them, ``topology.table``)
    tuning: str = "analytic"
    #: small/large allreduce switch (inclusive), bytes of the wire dtype
    small_cutoff_bytes: int = 16384
    #: -1: the topology preset's capacity, 0: per-leaf, >0: bytes
    bucket_bytes: int = -1

    def __post_init__(self):
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unsupported wire_dtype {self.wire_dtype!r}: expected one "
                f"of {WIRE_DTYPES}")
        if len(self.dp_axes) not in (1, 2) or \
                len(set(self.dp_axes)) != len(self.dp_axes):
            raise ValueError(
                f"dp_axes {self.dp_axes!r}: the stacked ranks carry one or "
                f"two distinct DP axes, such as ('pod', 'data')")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.wire_dtype == "int8":
            if self.backend not in _CODEC_BACKENDS + ("auto",):
                raise ValueError(
                    f"wire_dtype='int8' needs a codec-capable backend "
                    f"{_CODEC_BACKENDS} or 'auto', got {self.backend!r}")
            if self.bucket_bytes == 0:
                raise ValueError(
                    "wire_dtype='int8' runs on the bucketed flat-vector "
                    "path; bucket_bytes=0 disables bucketing")

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def opt_dp_order(self) -> Tuple[str, ...]:
        # bine_hier reduce-scatters data-first (intra-pod first), producing a
        # data-major block layout along the zero dim.
        if self.backend == "bine_hier" and len(self.dp_axes) > 1:
            return tuple(reversed(self.dp_axes))
        return self.dp_axes


def dp_shape(tcfg: TrainConfig, dp) -> Tuple[int, ...]:
    """The sizes of ``tcfg.dp_axes``: ``dp`` is their tuple, as the
    reference's mesh gives them, or one int for one axis."""
    shape = (int(dp),) if np.ndim(dp) == 0 else tuple(int(d) for d in dp)
    if len(shape) != len(tcfg.dp_axes) or min(shape) < 1:
        raise ValueError(f"DP sizes {shape} do not match dp_axes "
                         f"{tcfg.dp_axes}")
    return shape


def shard_owner(tcfg: TrainConfig, shape: Tuple[int, ...]) -> np.ndarray:
    """``owner[r]``: the ZeRO shard (block along a leaf's zero dim, row of a
    bucket) stacked rank r holds: r's index in ``opt_dp_order``, which
    is r itself but under two-axis ``bine_hier``."""
    coords = np.unravel_index(np.arange(int(np.prod(shape))), shape)
    axes = [tcfg.dp_axes.index(a) for a in tcfg.opt_dp_order]
    return np.ravel_multi_index([coords[a] for a in axes],
                                [shape[a] for a in axes])


# ---------------------------------------------------------------------------
# The stacked ranks
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ranks:
    """The ranks one step stacks: the DP axes' sizes ``dp`` and the model
    axis's ``tp``.  Row ``r * tp + t`` is TP rank t of DP rank r (row-major
    over ``(*dp, tp)``, the reference's mesh order).  The DP collectives
    run over the DP ranks within each TP column; at ``tp == 1`` they run
    over the whole stack, as before tensor parallelism."""
    dp: Tuple[int, ...]
    tp: int = 1

    @property
    def n_dp(self) -> int:
        return int(np.prod(self.dp))

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.dp + ((self.tp,) if self.tp > 1 else ())

    def over_dp(self, fn, x, *args):
        """``fn`` over all the DP ranks (the flattened DP axes)."""
        if self.tp == 1:
            return fn(x, *args)
        return stacked.over_axis(fn, x, (self.n_dp, self.tp), 0, *args)

    def over_dp_axis(self, fn, x, axis: int, *args):
        """``fn`` over DP axis ``axis`` alone (the two-tier hierarchy)."""
        return stacked.over_axis(fn, x, self.shape, axis, *args)

    def psum_tp(self, x):
        """The sum over the TP ranks of each DP rank, on every one."""
        return x if self.tp == 1 else self.over_tp(stacked.psum, x)

    def over_tp(self, fn, x, *args):
        """``fn`` over the TP ranks of each DP rank."""
        return stacked.over_axis(fn, x, (self.n_dp, self.tp), 1, *args)

    def per_dp(self, x, r: int):
        """DP rank r's rows of a stacked ``x [n_dp * tp, ...]``: ``[tp, ...]``
        (the bare row at ``tp == 1``)."""
        return x[r] if self.tp == 1 else x[r * self.tp:(r + 1) * self.tp]


# ---------------------------------------------------------------------------
# Gradient collectives (bucketed flat + per-leaf dim-general), stacked
# ---------------------------------------------------------------------------

def _backend_for_bytes(tcfg: TrainConfig, collective: str, p: int,
                       nbytes: int) -> str:
    """Concrete backend for a gradient collective of ``nbytes`` payload
    (one rank's full vector, the table's convention)."""
    if tcfg.backend != "auto":
        return tcfg.backend
    from repro_torch.topology import select_backend
    return select_backend(collective, p, nbytes, tcfg.topology,
                          tuning=tcfg.tuning)


def _nbytes(arr: torch.Tensor, scale: int = 1) -> int:
    """One rank's bytes of ``arr [p, ...]``, times ``scale``."""
    return arr[0].numel() * arr.element_size() * scale


def _backend_for(tcfg: TrainConfig, collective: str, arr: torch.Tensor,
                 rk: Ranks, scale: int = 1) -> str:
    """``_backend_for_bytes`` for one stacked ``arr [p, ...]`` over the DP
    ranks: one rank's bytes times ``scale`` — the DP size where ``arr`` is
    one rank's shard (the allgather input), times the TP size where it is
    a TP shard: the reference prices the leaf it sees, the global one."""
    if tcfg.backend != "auto":
        return tcfg.backend
    return _backend_for_bytes(tcfg, collective, rk.n_dp, _nbytes(arr, scale))


def _wire_cast(tcfg: TrainConfig, g, n_dp: int):
    """One leaf to the wire dtype (per-leaf/replicated path): bf16 is
    pre-scaled by the exact ``1/n_dp`` before the reduce; int8 and auto
    leaves stay float32 (the codec runs on the bucketed path only)."""
    if tcfg.wire_dtype == "bfloat16":
        return (g / n_dp).to(torch.bfloat16)
    return g.to(torch.float32)


def _post_reduce_div(tcfg: TrainConfig, n_dp: int) -> float:
    return 1.0 if tcfg.wire_dtype == "bfloat16" else float(n_dp)


def _bucket_wire_cast(wire: str, g, n_dp: int):
    """``_wire_cast`` for one bucket's wire: int8 pre-scales like bf16."""
    if wire == "bfloat16":
        return (g / n_dp).to(torch.bfloat16)
    if wire == "int8":
        return g.to(torch.float32) / n_dp
    return g.to(torch.float32)


def _bucket_post(wire: str, n_dp: int) -> float:
    return 1.0 if wire in ("bfloat16", "int8") else float(n_dp)


def _two_tier(b: str, rk: Ranks) -> bool:
    """Whether backend ``b`` runs the hierarchy: ``bine_hier`` over two
    axes (over one it is flat bine)."""
    return b == "bine_hier" and len(rk.dp) > 1


def _rs_leaf(tcfg: TrainConfig, g, zd: int, rk: Ranks, scale: int = 1):
    """Reduce ``g [p, ...]`` over the DP ranks; scatter along zd, or a full
    allreduce when zd < 0.  ``scale``: the TP size for a TP-sharded leaf
    (see ``_backend_for``)."""
    wire = _wire_cast(tcfg, g, rk.n_dp)
    if zd < 0:
        b = _backend_for(tcfg, "allreduce", wire, rk, scale)
        if b == "xla":
            return rk.over_dp(stacked.psum, wire)
        if b == "ring":
            return rk.over_dp(stacked.allreduce_ring, wire)
        if _two_tier(b, rk):         # inner (data) RS, pod allreduce, AG
            return stacked.allreduce_hierarchical(wire, rk.shape, 1, 0,
                                                  "bine")
        algo = "recdoub" if b == "recdoub" else "bine"
        if _nbytes(wire, scale) <= tcfg.small_cutoff_bytes:   # inclusive
            return rk.over_dp(stacked.allreduce_small, wire, algo)
        if b == "pallas_fused":
            return rk.over_dp(fused.allreduce, wire, "bine")
        return rk.over_dp(stacked.allreduce_butterfly, wire, algo)
    b = _backend_for(tcfg, "reduce_scatter", wire, rk, scale)
    if b == "xla":
        return rk.over_dp(stacked.psum_scatter, wire, zd)
    if _two_tier(b, rk):             # intra-pod (data) first, then pod
        out = rk.over_dp_axis(stacked.reduce_scatter_dim, wire, 1, zd, "bine")
        return rk.over_dp_axis(stacked.reduce_scatter_dim, out, 0, zd, "bine")
    if b == "pallas_fused":
        return rk.over_dp(fused.reduce_scatter_dim, wire, zd, "bine")
    return rk.over_dp(stacked.reduce_scatter_dim, wire, zd, _algo(b))


def _algo(b: str) -> str:
    return {"bine": "bine", "bine_hier": "bine", "recdoub": "recdoub",
            "ring": "ring"}[b]


def _ag_leaf(tcfg: TrainConfig, x, zd: int, rk: Ranks, scale: int = 1):
    if zd < 0:
        return x
    b = _backend_for(tcfg, "allgather", x, rk, scale * rk.n_dp)
    if b == "xla":
        return rk.over_dp(stacked.all_gather, x, zd)
    if _two_tier(b, rk):             # pod, then data (the RS inverted)
        out = rk.over_dp_axis(stacked.allgather_dim, x, 0, zd, "bine")
        return rk.over_dp_axis(stacked.allgather_dim, out, 1, zd, "bine")
    if b == "pallas_fused":
        return rk.over_dp(fused.allgather_dim, x, zd, "bine")
    return rk.over_dp(stacked.allgather_dim, x, zd, _algo(b))


def _rs_bucket(b: str, v, rk: Ranks):
    """One flat reduce-scatter of ``v [p, L]`` -> ``[p, L/n_dp]`` on the
    bucket's static backend decision; two-axis ``bine_hier`` runs the
    per-leaf path's axis order, so rank r's row is block ``owner[r]``."""
    if b == "xla":
        return rk.over_dp(stacked.psum_scatter, v, 0)
    if _two_tier(b, rk):
        out = rk.over_dp_axis(stacked.reduce_scatter, v, 1, "bine")
        return rk.over_dp_axis(stacked.reduce_scatter, out, 0, "bine")
    if b == "pallas_fused":
        return rk.over_dp(fused.reduce_scatter, v, "bine")
    return rk.over_dp(stacked.reduce_scatter, v, _algo(b))


def _ag_bucket(b: str, row, rk: Ranks):
    """Inverse flat allgather: ``[p, L/n_dp]`` -> the full bucket."""
    if b == "xla":
        return rk.over_dp(stacked.all_gather, row, 0)
    if _two_tier(b, rk):
        out = rk.over_dp_axis(stacked.allgather, row, 0, "bine")
        return rk.over_dp_axis(stacked.allgather, out, 1, "bine")
    if b == "pallas_fused":
        return rk.over_dp(fused.allgather, row, "bine")
    return rk.over_dp(stacked.allgather, row, _algo(b))


def _rs_bucket_q(backend: str, v, rk: Ranks):
    """int8-wire flat reduce-scatter; the stacked and fused twins decode
    bit-identically, so the backend changes speed, never the result."""
    if backend == "pallas_fused":
        return rk.over_dp(fused.reduce_scatter_q, v, "bine")
    return rk.over_dp(stacked.reduce_scatter_q, v, backend)


def _ag_bucket_q(backend: str, row, rk: Ranks):
    if backend == "pallas_fused":
        return rk.over_dp(fused.allgather_q, row, "bine")
    return rk.over_dp(stacked.allgather_q, row, backend)


def _small_allreduce(tcfg: TrainConfig, x, rk: Ranks):
    """The grad-norm and metrics vector: the small full-vector path
    (pallas_fused shares bine's tree: nothing to fuse)."""
    b = _backend_for(tcfg, "allreduce", x, rk)
    if b == "xla":
        return rk.over_dp(stacked.psum, x)
    if b == "ring":
        return rk.over_dp(stacked.allreduce_ring, x)
    return rk.over_dp(stacked.allreduce_small, x,
                      "recdoub" if b == "recdoub" else "bine")


def resolve_bucket_plan(tcfg: TrainConfig, n_dp: int, params_shapes,
                        layout) -> Optional[buckets.BucketPlan]:
    """The step's static bucket plan (None = bucketing off).  Capacity:
    ``bucket_bytes`` > 0 verbatim, -1 the topology preset's entry, 0 or
    one rank turns bucketing off.  ``auto`` wires plan at float32 width."""
    if n_dp <= 1 or tcfg.bucket_bytes == 0:
        return None
    cap = tcfg.bucket_bytes
    if cap < 0:
        from repro_torch.topology import select_bucket_bytes
        cap = select_bucket_bytes(n_dp, tcfg.topology, tuning=tcfg.tuning)
    wire_itemsize = comp.WIRE_BYTES_PER_ELEM.get(tcfg.wire_dtype, 4.0)
    plan = buckets.plan_buckets(params_shapes, layout, n_dp, cap,
                                wire_itemsize)
    return plan if plan.buckets else None


def _bucket_decision(tcfg: TrainConfig, collective: str, p: int,
                     f32_bytes: int, wire_bytes: int) -> Tuple[str, str]:
    """Joint ``(backend, wire_dtype)`` for one bucket collective.

    ``wire_dtype="auto"`` reads the table's joint wire row at the bucket's
    float32 payload; a pinned backend keeps its choice and takes the wire
    only if it has a codec.  An explicit wire prices the backend at the
    wire payload; an auto-resolved codec-less backend under explicit int8
    snaps to "bine"."""
    wire = tcfg.wire_dtype
    if wire == "auto":
        if p & (p - 1):
            return _backend_for_bytes(tcfg, collective, p, f32_bytes), \
                "float32"
        from repro_torch.topology import select_wire
        b, w = select_wire(collective, p, f32_bytes, tcfg.topology,
                           tuning=tcfg.tuning)
        if tcfg.backend != "auto":
            b = tcfg.backend
            if b not in _CODEC_BACKENDS:
                w = "float32"
        return b, w
    b = _backend_for_bytes(tcfg, collective, p, wire_bytes)
    if wire == "int8" and b not in _CODEC_BACKENDS:
        b = "bine"
    return b, wire


def bucket_decisions(tcfg: TrainConfig, plan: buckets.BucketPlan):
    """Static per-bucket ``(rs_backend, rs_wire, ag_backend, ag_wire)``.
    The RS prices the bucket's gradient payload, the AG its param-dtype
    payload; the allgather wire only goes int8 (a bf16 one gathers params
    at their own dtype)."""
    p = plan.n_dp
    out = []
    for b in plan.buckets:
        f32_rs = b.nbytes(4.0, p)
        rs_wire_bytes = b.nbytes(plan.wire_itemsize, p)
        ag_bytes = b.nbytes(getattr(torch, b.dtype).itemsize, p)
        rs_b, rs_w = _bucket_decision(tcfg, "reduce_scatter", p, f32_rs,
                                      rs_wire_bytes)
        ag_b, ag_w = _bucket_decision(tcfg, "allgather", p, ag_bytes,
                                      ag_bytes)
        if ag_w == "bfloat16":
            ag_w = "float32"
        out.append((rs_b, rs_w, ag_b, ag_w))
    return out


def bucket_report(tcfg: TrainConfig, plan: Optional[buckets.BucketPlan]):
    """Per-bucket dispatch report (the reference's ``bucket_report``): the
    resolved backends and wires with their payloads and where each
    decision came from — ``"measured"`` or ``"analytic"`` table cells
    under ``auto``, ``"fixed"`` where the config pins it."""
    if plan is None:
        return []
    from repro_torch.topology import (decision_provenance,
                                      wire_decision_provenance)
    rows = []
    for i, (b, (rs_b, rs_w, ag_b, ag_w)) in enumerate(
            zip(plan.buckets, bucket_decisions(tcfg, plan))):
        rs_bytes = b.nbytes(plan.wire_itemsize, plan.n_dp)
        ag_bytes = b.nbytes(getattr(torch, b.dtype).itemsize, plan.n_dp)
        if tcfg.backend == "auto":
            rs_src = decision_provenance("reduce_scatter", plan.n_dp,
                                         rs_bytes, tcfg.topology,
                                         tuning=tcfg.tuning)
            ag_src = decision_provenance("allgather", plan.n_dp, ag_bytes,
                                         tcfg.topology, tuning=tcfg.tuning)
        else:
            rs_src = ag_src = "fixed"
        if tcfg.wire_dtype == "auto":
            rs_wsrc = wire_decision_provenance(
                "reduce_scatter", plan.n_dp, b.nbytes(4.0, plan.n_dp),
                tcfg.topology, tuning=tcfg.tuning)
            ag_wsrc = wire_decision_provenance(
                "allgather", plan.n_dp, ag_bytes, tcfg.topology,
                tuning=tcfg.tuning)
        else:
            rs_wsrc = ag_wsrc = "fixed"
        rows.append({
            "bucket": i, "n_leaves": len(b.slots),
            "rs_backend": rs_b, "rs_bytes": rs_bytes, "rs_provenance": rs_src,
            "rs_wire": rs_w, "rs_wire_provenance": rs_wsrc,
            "ag_backend": ag_b, "ag_bytes": ag_bytes, "ag_provenance": ag_src,
            "ag_wire": ag_w, "ag_wire_provenance": ag_wsrc,
        })
    return rows


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Layout:
    """The static layout of a step over ``ranks``: per leaf (flatten
    order) its zero dim and, under TP, its model dim (-1: every TP rank
    holds it whole) and one TP rank's shape; the bucket plan (the
    reference's, over the global leaves) and its TP columns."""
    ranks: Ranks
    zero_dims: Tuple[int, ...]
    model_dims: Tuple[int, ...]
    local_shapes: Tuple[Tuple[int, ...], ...]
    plan: Optional[buckets.BucketPlan]
    local_plan: Optional[buckets.BucketPlan]


def _global_shapes(model_cfg, params_or_shapes, tp: int):
    """Global shapes: the tree itself at ``tp == 1`` (a rank's tree),
    the model's ``meta`` shapes under TP."""
    return params_or_shapes if tp == 1 else TF.param_shapes(model_cfg)


def step_layout(model_cfg, tcfg: TrainConfig, dp, params_shapes,
                tp: int = 1) -> Layout:
    """The :class:`Layout` of ``params_shapes`` (global) over the DP sizes
    ``dp`` and a model axis of ``tp``."""
    rk = Ranks(dp_shape(tcfg, dp), int(tp))
    zd_tree = zero.zero_layout(model_cfg, params_shapes, rk.n_dp, rk.tp)
    shapes = [tuple(x.shape) for x in T.flatten(params_shapes)]
    if rk.tp > 1:
        mds = tuple(T.flatten(SH.model_dims(model_cfg, params_shapes,
                                            rk.tp)))
    else:
        mds = (-1,) * len(shapes)
    local = tuple(SH.local_shape(sh, md, rk.tp) for sh, md in zip(shapes,
                                                                   mds))
    plan = resolve_bucket_plan(tcfg, rk.n_dp, params_shapes, zd_tree)
    lplan = plan if plan is None or rk.tp == 1 else \
        buckets.local_plan(plan, local)
    return Layout(rk, tuple(T.flatten(zd_tree)), mds, local, plan, lplan)


def _tp_gather(x: torch.Tensor, md: int) -> torch.Tensor:
    """``x [tp, *shard]`` -> the whole ``[tp, *leaf]`` on every TP rank (an
    all-gather over them along ``md``); a leaf each rank holds whole
    stays."""
    return stacked.all_gather(x, md) if md >= 0 else x


def _tp_own(x: torch.Tensor, md: int, rk: Ranks) -> torch.Tensor:
    """``x [p, *leaf block]``, whole on every TP rank -> each TP rank's
    own shard along ``md`` (a leaf each rank holds whole stays)."""
    if md < 0:
        return x
    return torch.cat([SH.rank_block(rk.per_dp(x, r), md)
                      for r in range(rk.n_dp)])


def _int8_buckets(tcfg: TrainConfig, plan) -> List[buckets.Bucket]:
    """The buckets whose reduce-scatter wire is int8 (error feedback)."""
    if plan is None:
        return []
    return [b for b, d in zip(plan.buckets, bucket_decisions(tcfg, plan))
            if d[1] == "int8"]


def _ef_init(tcfg: TrainConfig, lay: Layout, device) -> Dict[str, torch.Tensor]:
    """Zero error-feedback residuals ``[p, L]`` f32, one per int8 bucket
    (``L``: the global bucket's length; under TP every TP rank codes the
    whole bucket, see ``make_train_step``)."""
    rk = lay.ranks
    return {str(b.bid): torch.zeros((rk.n_dp * rk.tp, b.row_elems * rk.n_dp),
                                    dtype=torch.float32, device=device)
            for b in _int8_buckets(tcfg, lay.plan)}


def init_train_state(model_cfg, tcfg: TrainConfig, params: List[Any], dp,
                     tp: int = 1):
    """Optimizer state from the ranks' parameters: per leaf, every rank's
    ``zero_dim`` slice (block ``shard_owner[r]``) stacked ``[p, ...]`` (the
    whole leaf if replicated); under TP, of each TP rank's shard, in
    ``Ranks``' row order.  ``dp``: the DP axes' sizes (:func:`dp_shape`),
    ``tp``: the model axis's."""
    lay = step_layout(model_cfg, tcfg, dp,
                      _global_shapes(model_cfg, params[0], tp), tp)
    rk = lay.ranks
    owner = shard_owner(tcfg, rk.dp)
    flats = [T.flatten(tr) for tr in params]
    opt = []
    for i, zd in enumerate(lay.zero_dims):
        opt.append(adamw_init_leaf(torch.stack(
            [zero.slice_leaf(x, zd, rk.n_dp, int(owner[r]))
             for r in range(rk.n_dp)
             for x in ([flats[r][i]] if rk.tp == 1 else flats[r][i])])))
    device = flats[0][0].device
    state = {"opt": T.unflatten(params[0], opt),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    ef = _ef_init(tcfg, lay, device)
    if ef:
        state["ef"] = ef
    return state


def make_init_fns(model_cfg, tcfg: TrainConfig, dp, device="cuda",
                  tp: int = 1):
    """(init_params(seed) -> one tree per DP rank, init_state(params) ->
    state).  Every rank starts from the same weights, each in its own
    copy; under TP (``tp > 1``) each DP rank's tree is stacked over its TP
    ranks (``sharding.shard_params``).  ``dp``: the DP axes' sizes
    (:func:`dp_shape`)."""
    dev = resolve_device(device)
    n_dp = int(np.prod(dp_shape(tcfg, dp)))

    def init_p(seed: int = 0):
        one = TF.init_params(model_cfg, seed, dev)
        if tp > 1:
            one = SH.shard_params(model_cfg, one, tp)
        return [one] + [T.tree_map(torch.clone, one) for _ in range(n_dp - 1)]

    def init_s(params):
        return init_train_state(model_cfg, tcfg, params, dp, tp)

    return init_p, init_s


# ---------------------------------------------------------------------------
# The global layout of a train state (checkpoints)
# ---------------------------------------------------------------------------

def to_global(model_cfg, tcfg: TrainConfig, params: List[Any], state: Dict,
              dp, device=None, tp: int = 1) -> Dict:
    """The stacked per-rank ``params`` and ``state`` as the logical arrays
    a checkpoint holds: ``{"params": tree, "state": {"opt": tree of
    {"m", "master", "v"}, "step": scalar, ["ef": {bid: [n_dp, L]}]}}``.
    The global layout has no model axis: under TP each leaf is its TP
    ranks' shards joined, so a state saved at one ``(dp, tp)`` restores at
    any other, and a checkpoint of the reference's TP run (whose arrays
    are global) restores too.

    Params are one DP rank's tree; every DP rank must hold the same bits,
    and every TP rank the same bits of a leaf it holds whole.  A
    ZeRO-sharded optimizer leaf is whole: stacked DP rank r's slice is
    block ``shard_owner[r]`` along the leaf's zero dim; a replicated one is
    rank 0's copy, every rank's checked equal.  The error-feedback rows
    are per DP rank in ``dp_axes`` order, which is the stacking order;
    under TP each row is rebuilt from the TP columns in the reference's
    bucket order.  ``device``: where each leaf lands as it is built
    ("cpu" streams a state larger than the card's free memory to the
    host, leaf by leaf; "meta" gives shapes and dtypes only); None keeps
    the params' device.  Every leaf is a new tensor or a rank's params,
    never a view of the state the step updates in place."""
    shape = dp_shape(tcfg, dp)
    n_dp = int(np.prod(shape))
    if len(params) != n_dp:
        raise ValueError(f"{len(params)} rank trees for DP sizes {shape}")
    meta = device is not None and torch.device(device).type == "meta"
    order = [int(r) for r in np.argsort(shard_owner(tcfg, shape))]
    lay = step_layout(model_cfg, tcfg, dp,
                      _global_shapes(model_cfg, params[0], tp), tp)

    def put(t: torch.Tensor) -> torch.Tensor:
        return t if device is None else t.to(device)

    flats = [T.flatten_with_path(tr) for tr in params]
    glob_p = []
    for i, (path, leaf) in enumerate(flats[0]):
        if not meta:
            for r in range(1, n_dp):
                if not torch.equal(flats[r][i][1], leaf):
                    raise ValueError(
                        f"{T.keystr(('params',) + path)}: rank {r}'s "
                        f"parameter differs from rank 0's")
        if tp > 1:
            leaf = SH.join_leaf(leaf, lay.model_dims[i],
                                T.keystr(("params",) + path))
        glob_p.append(put(leaf))
    opt = []
    for i, ((path, _), zd, st) in enumerate(zip(
            flats[0], lay.zero_dims,
            T.flatten_up_to(params[0], state["opt"]))):
        md = lay.model_dims[i]
        one = {}
        for k in sorted(st):
            x = st[k]
            what = T.keystr(("state", "opt") + path + (k,))
            if tp > 1:        # join the TP shards of each DP rank's block
                x = x.unflatten(0, (n_dp, tp))
                x = torch.cat(list(x.unbind(1)), dim=md + 1) if md >= 0 \
                    else torch.stack([SH.join_leaf(x[r], -1, what)
                                      for r in range(n_dp)])
            if meta:
                full = list(x.shape[1:])
                if zd >= 0:
                    full[zd] *= n_dp
                one[k] = torch.empty(full, dtype=x.dtype, device="meta")
            elif zd >= 0:
                one[k] = put(torch.cat([x[r] for r in order], dim=zd))
            else:
                for r in range(1, n_dp):
                    if not torch.equal(x[r], x[0]):
                        raise ValueError(f"{what}: rank {r}'s replicated "
                                         f"copy differs")
                one[k] = put(x[0].clone())
        opt.append(one)
    out_state = {"opt": T.unflatten(params[0], opt),
                 "step": put(state["step"].clone())}
    if "ef" in state:
        out_state["ef"] = {k: put(_ef_to_global(lay, k, v, meta))
                           for k, v in state["ef"].items()}
    out_params = T.unflatten(params[0], glob_p)
    return {"params": out_params, "state": out_state}


def _ef_to_global(lay: Layout, bid: str, v: torch.Tensor, meta: bool):
    """One bucket's residual ``[p, L]`` -> the global ``[n_dp, L]``: under
    TP every TP rank of a DP rank holds the same row (checked)."""
    rk = lay.ranks
    if rk.tp == 1:
        return v.clone()
    v = v.unflatten(0, (rk.n_dp, rk.tp))
    if meta:
        return torch.empty_like(v[:, 0], device="meta")
    for t in range(1, rk.tp):
        if not torch.equal(v[:, t], v[:, 0]):
            raise ValueError(f"['state']['ef'][{bid!r}]: TP rank {t}'s "
                             f"residual differs")
    return v[:, 0].clone()


def from_global(model_cfg, tcfg: TrainConfig, tree: Dict, dp,
                device="cuda", tp: int = 1) -> Tuple[List[Any], Dict]:
    """Inverse of :func:`to_global` for the DP sizes ``dp`` and the model
    axis ``tp`` (any, not only the ones the tree was saved at):
    ``(params, state)`` stacked on ``device``.  The optimizer leaves are
    cut by ``zero.zero_layout`` at this ``n_dp`` (and ``tp``), handed out
    by ``shard_owner`` and, under TP, split over the TP ranks as their
    params are; the error-feedback rows must match this config's int8
    buckets at this ``n_dp`` (they are per-rank residuals and cannot be
    re-sliced), as the reference's restore asserts their global shape."""
    dev = resolve_device(device)
    one = T.tree_map(lambda x: x.to(dev), tree["params"])
    lay = step_layout(model_cfg, tcfg, dp, _global_shapes(model_cfg, one, tp),
                      tp)
    rk = lay.ranks
    owner = shard_owner(tcfg, rk.dp)
    if tp > 1:
        one = SH.shard_params(model_cfg, one, tp)
    params = [one] + [T.tree_map(torch.clone, one)
                      for _ in range(rk.n_dp - 1)]

    def cut(v, zd, md):
        """A global optimizer leaf -> ``[p, ...]`` in ``Ranks``' order."""
        v = v.to(dev)
        if zd < 0:
            rows = [v] * rk.n_dp
        else:
            rows = [zero.slice_leaf(v, zd, rk.n_dp, int(owner[r]))
                    for r in range(rk.n_dp)]
        if tp > 1:
            return torch.cat([SH.split_leaf(x, md, tp) for x in rows])
        return torch.stack(rows) if zd >= 0 else v.expand(
            (rk.n_dp,) + tuple(v.shape)).clone()

    opt = [{k: cut(v, zd, md) for k, v in st.items()}
           for zd, md, st in zip(lay.zero_dims, lay.model_dims,
                                 T.flatten_up_to(tree["params"],
                                                 tree["state"]["opt"]))]
    state = {"opt": T.unflatten(one, opt),
             "step": tree["state"]["step"].to(dev, torch.int32)}
    want = {str(b.bid): (rk.n_dp, b.row_elems * rk.n_dp)
            for b in _int8_buckets(tcfg, lay.plan)}
    got = tree["state"].get("ef", {})
    if sorted(want) != sorted(got):
        raise ValueError(
            f"['state']['ef']: the checkpoint's int8 buckets {sorted(got)} "
            f"are not this config's {sorted(want)} at n_dp={rk.n_dp}")
    for bid, v in got.items():
        if tuple(v.shape) != want[bid]:
            raise ValueError(
                f"['state']['ef'][{bid!r}]: ckpt {tuple(v.shape)} vs "
                f"expected {want[bid]} at n_dp={rk.n_dp}")
    if want:
        state["ef"] = {k: v.to(dev, torch.float32).repeat_interleave(
            rk.tp, dim=0) for k, v in got.items()}
    return params, state


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _rank_grads(model_cfg, tcfg: TrainConfig, params, batch, tp: int = 1):
    """One DP rank's (flat grads, metrics) on its batch shard.  Under TP
    its whole TP group runs at once (collectives sit mid-forward): leaves
    and grads are ``[tp, ...]``, every metric ``[tp]``, and the scalar
    differentiated is the ranks' mean loss (each rank's loss is the same
    function of all ranks' values)."""
    leaves = [x.detach().requires_grad_(True) for x in T.flatten(params)]
    tree = T.unflatten(params, leaves)

    def lossf(mb):
        loss, metrics = TF.loss_fn(tree, model_cfg, mb, n_model=tp)
        return (loss.mean() if tp > 1 else loss), metrics

    def grad(loss):
        # a leaf the inputs never reach (a frontend model's ``embed`` on
        # frames) gets zeros, as JAX's gradient of it is
        return torch.autograd.grad(loss, leaves, allow_unused=True,
                                   materialize_grads=True)

    A = tcfg.accum_steps
    if A == 1:
        loss, metrics = lossf(batch)
        grads = list(grad(loss))
        return grads, {k: v.detach() for k, v in metrics.items()}
    mbs = {k: v.reshape((A, v.shape[0] // A) + tuple(v.shape[1:]))
           for k, v in batch.items()}
    g_acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
             for x in leaves]
    me_acc: Dict[str, torch.Tensor] = {}
    for a in range(A):
        loss, me = lossf({k: v[a] for k, v in mbs.items()})
        for acc, g in zip(g_acc, grad(loss)):
            acc += g.to(torch.float32)
        for k, v in me.items():
            me_acc[k] = me_acc.get(k, 0.0) + v.detach().to(torch.float32)
    return [g / A for g in g_acc], {k: v / A for k, v in me_acc.items()}


def _tp_sum_replicated(grads, mds):
    """A leaf each TP rank holds whole (model dim < 0) saw only that
    rank's share of the work: its ``[tp, ...]`` gradients summed over the
    TP ranks (GSPMD's implicit reduction), before the DP collectives."""
    return [stacked.psum(x) if md < 0 else x for x, md in zip(grads, mds)]


def make_train_step(model_cfg, tcfg: TrainConfig, dp, params_shapes,
                    device="cuda", tp: int = 1):
    """Returns ``(step, info, layout)``.

    ``dp`` gives the sizes of ``tcfg.dp_axes`` (:func:`dp_shape`: an int
    for one axis), ``tp`` the model axis's; the ranks are stacked
    row-major over ``(*dp, tp)`` (:class:`Ranks`).  ``params_shapes``: the
    global parameter tree (or its shapes).  ``step(params, state, batch)
    -> (params, state, metrics)``: ``params`` a list of ``n_dp`` per-rank
    trees (under TP each stacked over its TP ranks,
    ``sharding.shard_params``), ``batch`` the global batch (numpy or
    tensors, ``[B, T]``) split over the DP ranks along dim 0, every TP
    rank of a DP rank reading its shard.  The step updates ``state``'s
    optimizer and error-feedback buffers in place: hand the state over,
    as the reference step donates it.  ``info`` holds the static
    ``bucket_plan`` (None = per-leaf collectives), its ``decisions`` and
    the step's :class:`Layout`."""
    dev = resolve_device(device)
    lay = step_layout(model_cfg, tcfg, dp, params_shapes, tp)
    rk = lay.ranks
    n_dp = rk.n_dp
    if n_dp > 1 and not executable_at(tcfg.backend, n_dp):
        raise ValueError(
            f"backend={tcfg.backend!r} cannot execute at non-power-of-"
            f"two n_dp={n_dp} (butterfly schedules need pow2 rank counts); "
            f"use backend='ring' or 'xla'")
    plan = lay.plan
    if tcfg.wire_dtype == "int8":
        if n_dp & (n_dp - 1):
            raise ValueError(
                f"wire_dtype='int8' needs a power-of-two DP rank count "
                f"(the codec schedules are butterfly-only), got {n_dp}")
        if plan is None and n_dp > 1:
            raise ValueError("wire_dtype='int8' needs the bucketed path; "
                             "this model has no bucketable (ZeRO-sharded) "
                             "leaves")
    decisions = None if plan is None else bucket_decisions(tcfg, plan)
    if decisions is not None:
        # telemetry: the step's static per-bucket dispatches, once per build
        from repro_torch.obs import collect
        collect.record_bucket_plan(tcfg, plan, decisions, n_dp)
    flat_zd = list(lay.zero_dims)
    mds = lay.model_dims
    lead = 1 if rk.tp > 1 else 0     # a DP rank's leaves: [tp, ...] under TP
    p_all = n_dp * rk.tp
    #: pricing scale of each leaf: the reference sees the global leaf
    tp_scale = [rk.tp if md >= 0 else 1 for md in mds]

    def step(params, state, batch):
        flat_p = [T.flatten(tr) for tr in params]
        flat_opt = T.flatten_up_to(params[0], state["opt"])
        step_no = state["step"]
        nleaf = len(flat_zd)

        # ---- forward/backward, one DP rank (and its TP group) at a time ----
        grads: List[List[Optional[torch.Tensor]]] = []
        mets = []
        shards = {k: torch.as_tensor(np.asarray(v)).to(dev).chunk(n_dp)
                  for k, v in batch.items()}
        for r in range(n_dp):
            g, m = _rank_grads(model_cfg, tcfg, params[r],
                               {k: v[r] for k, v in shards.items()}, rk.tp)
            if rk.tp > 1:
                g = _tp_sum_replicated(g, mds)
            grads.append(g)
            mets.append(m)

        def take(i):
            """Leaf i's gradients stacked [p, ...]; the ranks' copies go."""
            g = torch.stack([grads[r][i] for r in range(n_dp)])
            for r in range(n_dp):
                grads[r][i] = None
            return g.flatten(0, 1) if rk.tp > 1 else g

        # ---- DP gradient reduce-scatter ----
        post = _post_reduce_div(tcfg, n_dp)
        g_sh: List[Optional[torch.Tensor]] = [None] * nleaf
        new_ef: Dict[str, torch.Tensor] = {}
        if plan is None:
            for i, zd in enumerate(flat_zd):
                g_sh[i] = _rs_leaf(tcfg, take(i), zd, rk, tp_scale[i]).to(
                    torch.float32) / post
        else:
            for i in plan.replicated:
                g_sh[i] = _rs_leaf(tcfg, take(i), -1, rk, tp_scale[i]).to(
                    torch.float32) / post
            for gb, lb, (rs_b, rs_w, _, _) in zip(
                    plan.buckets, lay.local_plan.buckets, decisions):
                # the int8 codec runs on the global bucket on every TP
                # rank, as GSPMD lays it out (each rank's column would
                # quantize other chunks); the other wires on the columns
                whole = rk.tp > 1 and rs_w == "int8"
                bucket = gb if whole else lb
                v = None
                for r in range(n_dp):
                    row = buckets.pack_bucket(
                        bucket, [_bucket_wire_cast(
                            rs_w, _tp_gather(grads[r][s.index],
                                             mds[s.index]) if whole
                            else grads[r][s.index], n_dp)
                            for s in bucket.slots], n_dp, lead)
                    if v is None:
                        v = torch.empty((n_dp,) + tuple(row.shape),
                                        dtype=row.dtype, device=row.device)
                    v[r] = row
                    del row
                    for s in bucket.slots:   # this rank's grads are packed
                        grads[r][s.index] = None
                v = v.view(p_all, -1)
                if rs_w == "int8":
                    # error feedback: the codec's quantization error rides
                    # into next step's gradient
                    bid = str(bucket.bid)
                    v, new_ef[bid] = comp.ef_compress(v, state["ef"][bid],
                                                      codec="wire_int8")
                    row = _rs_bucket_q(rs_b, v, rk)
                else:
                    row = _rs_bucket(rs_b, v, rk)
                del v
                row = row.to(torch.float32) / _bucket_post(rs_w, n_dp)
                for s, view in zip(bucket.slots,
                                   buckets.shard_views(bucket, row, n_dp)):
                    g_sh[s.index] = _tp_own(view, mds[s.index], rk) \
                        if whole else view

        # ---- grad-norm + metrics: ONE stacked small allreduce ----
        def sq(i):
            """Leaf i's sum of squares per rank: under TP the whole
            block's, each element counted once."""
            g = g_sh[i]
            out = torch.sum(torch.square(g), dim=tuple(range(1, g.dim())))
            return rk.psum_tp(out) if mds[i] >= 0 else out

        zeros = torch.zeros(p_all, dtype=torch.float32, device=dev)
        sq_shard = sum((sq(i) for i, zd in enumerate(flat_zd) if zd >= 0),
                       zeros)
        sq_repl = sum((sq(i) for i, zd in enumerate(flat_zd) if zd < 0),
                      zeros)
        mkeys = sorted(mets[0])
        vec = torch.stack(
            [sq_shard] + [torch.stack([m[k] for m in mets]).to(
                torch.float32).reshape(-1) for k in mkeys], dim=1)
        red = _small_allreduce(tcfg, vec, rk)
        gnorm = torch.sqrt(red[:, 0] + sq_repl)
        if tcfg.clip_norm > 0:
            scale = torch.clamp(tcfg.clip_norm / (gnorm + 1e-9), max=1.0)
        else:
            scale = torch.ones_like(gnorm)

        # ---- sharded AdamW + parameter allgather ----
        lr = lr_at(tcfg.adamw, step_no)
        new_opt: List[Any] = [None] * nleaf
        new_p: List[List[Any]] = [[None] * nleaf for _ in range(n_dp)]

        def upd(i):
            g = g_sh[i] * scale.view((-1,) + (1,) * (g_sh[i].dim() - 1))
            g_sh[i] = None
            master, new_opt[i] = adamw_update_leaf(
                tcfg.adamw, flat_opt[i], g, step_no, lr)
            # a copy even at the same dtype: the master updates in place
            return master.to(flat_p[0][i].dtype, copy=True)

        def scatter_ranks(i, stacked_leaf):
            for r in range(n_dp):
                new_p[r][i] = rk.per_dp(stacked_leaf, r)

        if plan is None:
            for i, zd in enumerate(flat_zd):
                scatter_ranks(i, _ag_leaf(tcfg, upd(i), zd, rk, tp_scale[i]))
        else:
            for i in plan.replicated:
                scatter_ranks(i, upd(i))
            for gb, lb, (_, _, ag_b, ag_w) in zip(
                    plan.buckets, lay.local_plan.buckets, decisions):
                whole = rk.tp > 1 and ag_w == "int8"
                bucket = gb if whole else lb
                masters = [upd(s.index) for s in bucket.slots]
                if whole:
                    masters = [rk.over_tp(_tp_gather, x, mds[s.index])
                               for x, s in zip(masters, bucket.slots)]
                packed = buckets.pack_shards(bucket, masters, lead=1)
                del masters
                if ag_w == "int8":
                    full = _ag_bucket_q(ag_b, packed, rk).to(
                        getattr(torch, bucket.dtype))
                else:
                    full = _ag_bucket(ag_b, packed, rk)
                del packed
                for r in range(n_dp):
                    for s, leaf in zip(bucket.slots, buckets.unpack_bucket(
                            bucket, rk.per_dp(full, r), n_dp, lead)):
                        md = mds[s.index]
                        new_p[r][s.index] = SH.rank_block(leaf, md) \
                            if whole and md >= 0 else leaf
                del full

        out_params = [T.unflatten(params[0], new_p[r]) for r in range(n_dp)]
        metrics = {k: red[0, j + 1] / n_dp for j, k in enumerate(mkeys)}
        metrics["grad_norm"] = gnorm[0]
        metrics["lr"] = lr
        new_state = {"opt": T.unflatten(params[0], new_opt),
                     "step": step_no + 1}
        if new_ef:
            new_state["ef"] = new_ef
        return out_params, new_state, metrics

    layout = T.unflatten(params_shapes, list(flat_zd))
    return step, {"bucket_plan": plan, "decisions": decisions,
                  "layout": lay}, layout
