"""The training step: DP ranks stacked on one device, Bine gradient
collectives, ZeRO-1 AdamW.

Port of ``repro.train.step`` (model axis 1).  The reference runs the step
body under ``shard_map`` on p devices; here the p ranks run on one device:

  * every rank holds its own parameters — ``params`` is a list of p trees —
    and runs forward and backward on its own batch shard, one rank after
    another;
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
    two DP axes (stacked on one device), model axis 1, the packaged
    (analytic) tables."""
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
    #: table provenance: "analytic" (the packaged tables); "measured" is
    #: not ported and raises at lookup
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


def _backend_for(tcfg: TrainConfig, collective: str, arr: torch.Tensor,
                 gathered: bool = False) -> str:
    """``_backend_for_bytes`` for one stacked ``arr [p, ...]``: one rank's
    bytes, scaled by p where ``arr`` is one rank's shard (``gathered``)."""
    if tcfg.backend != "auto":
        return tcfg.backend
    p = arr.shape[0]
    nbytes = arr[0].numel() * arr.element_size() * (p if gathered else 1)
    return _backend_for_bytes(tcfg, collective, p, nbytes)


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


def _two_tier(b: str, shape: Tuple[int, ...]) -> bool:
    """Whether backend ``b`` runs the hierarchy: ``bine_hier`` over two
    axes (over one it is flat bine)."""
    return b == "bine_hier" and len(shape) > 1


def _rs_leaf(tcfg: TrainConfig, g, zd: int, shape: Tuple[int, ...]):
    """Reduce ``g [p, ...]`` over the ranks; scatter along zd, or a full
    allreduce when zd < 0."""
    n_dp = int(np.prod(shape))
    wire = _wire_cast(tcfg, g, n_dp)
    if zd < 0:
        b = _backend_for(tcfg, "allreduce", wire)
        if b == "xla":
            return stacked.psum(wire)
        if b == "ring":
            return stacked.allreduce_ring(wire)
        if _two_tier(b, shape):     # inner (data) RS, pod allreduce, AG
            return stacked.allreduce_hierarchical(wire, shape, 1, 0, "bine")
        algo = "recdoub" if b == "recdoub" else "bine"
        per_rank = wire[0].numel() * wire.element_size()
        if per_rank <= tcfg.small_cutoff_bytes:    # inclusive boundary
            return stacked.allreduce_small(wire, algo)
        if b == "pallas_fused":
            return fused.allreduce(wire, "bine")
        return stacked.allreduce_butterfly(wire, algo)
    b = _backend_for(tcfg, "reduce_scatter", wire)
    if b == "xla":
        return stacked.psum_scatter(wire, zd)
    if _two_tier(b, shape):         # intra-pod (data) first, then pod
        out = stacked.over_axis(stacked.reduce_scatter_dim, wire, shape, 1,
                                zd, "bine")
        return stacked.over_axis(stacked.reduce_scatter_dim, out, shape, 0,
                                 zd, "bine")
    if b == "pallas_fused":
        return fused.reduce_scatter_dim(wire, zd, "bine")
    return stacked.reduce_scatter_dim(wire, zd, _algo(b))


def _algo(b: str) -> str:
    return {"bine": "bine", "bine_hier": "bine", "recdoub": "recdoub",
            "ring": "ring"}[b]


def _ag_leaf(tcfg: TrainConfig, x, zd: int, shape: Tuple[int, ...]):
    if zd < 0:
        return x
    b = _backend_for(tcfg, "allgather", x, gathered=True)
    if b == "xla":
        return stacked.all_gather(x, zd)
    if _two_tier(b, shape):         # pod, then data (the RS inverted)
        out = stacked.over_axis(stacked.allgather_dim, x, shape, 0, zd,
                                "bine")
        return stacked.over_axis(stacked.allgather_dim, out, shape, 1, zd,
                                 "bine")
    if b == "pallas_fused":
        return fused.allgather_dim(x, zd, "bine")
    return stacked.allgather_dim(x, zd, _algo(b))


def _rs_bucket(b: str, v, shape: Tuple[int, ...]):
    """One flat reduce-scatter of ``v [p, L]`` -> ``[p, L/p]`` on the
    bucket's static backend decision; two-axis ``bine_hier`` runs the
    per-leaf path's axis order, so rank r's row is block ``owner[r]``."""
    if b == "xla":
        return stacked.psum_scatter(v, 0)
    if _two_tier(b, shape):
        out = stacked.over_axis(stacked.reduce_scatter, v, shape, 1, "bine")
        return stacked.over_axis(stacked.reduce_scatter, out, shape, 0,
                                 "bine")
    if b == "pallas_fused":
        return fused.reduce_scatter(v, "bine")
    return stacked.reduce_scatter(v, _algo(b))


def _ag_bucket(b: str, row, shape: Tuple[int, ...]):
    """Inverse flat allgather: ``[p, L/p]`` -> the full bucket ``[p, L]``."""
    if b == "xla":
        return stacked.all_gather(row, 0)
    if _two_tier(b, shape):
        out = stacked.over_axis(stacked.allgather, row, shape, 0, "bine")
        return stacked.over_axis(stacked.allgather, out, shape, 1, "bine")
    if b == "pallas_fused":
        return fused.allgather(row, "bine")
    return stacked.allgather(row, _algo(b))


def _rs_bucket_q(backend: str, v):
    """int8-wire flat reduce-scatter; the stacked and fused twins decode
    bit-identically, so the backend changes speed, never the result."""
    if backend == "pallas_fused":
        return fused.reduce_scatter_q(v, "bine")
    return stacked.reduce_scatter_q(v, backend)


def _ag_bucket_q(backend: str, row):
    if backend == "pallas_fused":
        return fused.allgather_q(row, "bine")
    return stacked.allgather_q(row, backend)


def _small_allreduce(tcfg: TrainConfig, x):
    """The grad-norm and metrics vector: the small full-vector path
    (pallas_fused shares bine's tree: nothing to fuse)."""
    b = _backend_for(tcfg, "allreduce", x)
    if b == "xla":
        return stacked.psum(x)
    if b == "ring":
        return stacked.allreduce_ring(x)
    return stacked.allreduce_small(x, "recdoub" if b == "recdoub" else "bine")


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


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

def _ef_init(tcfg: TrainConfig, plan, device) -> Dict[str, torch.Tensor]:
    """Zero error-feedback residuals ``[p, L]`` f32, one per int8 bucket."""
    if plan is None:
        return {}
    return {str(b.bid): torch.zeros((plan.n_dp, b.row_elems * plan.n_dp),
                                    dtype=torch.float32, device=device)
            for b, d in zip(plan.buckets, bucket_decisions(tcfg, plan))
            if d[1] == "int8"}


def init_train_state(model_cfg, tcfg: TrainConfig, params: List[Any], dp):
    """Optimizer state from the ranks' parameters: per leaf, every rank's
    ``zero_dim`` slice (block ``shard_owner[r]``) stacked ``[p, ...]`` (the
    whole leaf if replicated).  ``dp``: the DP axes' sizes
    (:func:`dp_shape`)."""
    shape = dp_shape(tcfg, dp)
    n_dp = int(np.prod(shape))
    owner = shard_owner(tcfg, shape)
    layout = zero.zero_layout(model_cfg, params[0], n_dp)
    flats = [T.flatten(tr) for tr in params]
    opt = []
    for i, zd in enumerate(T.flatten(layout)):
        opt.append(adamw_init_leaf(torch.stack(
            [zero.slice_leaf(flats[r][i], zd, n_dp, int(owner[r]))
             for r in range(n_dp)])))
    device = flats[0][0].device
    state = {"opt": T.unflatten(params[0], opt),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    ef = _ef_init(tcfg, resolve_bucket_plan(tcfg, n_dp, params[0], layout),
                  device)
    if ef:
        state["ef"] = ef
    return state


def make_init_fns(model_cfg, tcfg: TrainConfig, dp, device="cuda"):
    """(init_params(seed) -> p per-rank trees, init_state(params) -> state).
    Every rank starts from the same weights, each in its own copy.
    ``dp``: the DP axes' sizes (:func:`dp_shape`)."""
    dev = resolve_device(device)
    n_dp = int(np.prod(dp_shape(tcfg, dp)))

    def init_p(seed: int = 0):
        one = TF.init_params(model_cfg, seed, dev)
        return [one] + [T.tree_map(torch.clone, one) for _ in range(n_dp - 1)]

    def init_s(params):
        return init_train_state(model_cfg, tcfg, params, dp)

    return init_p, init_s


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _rank_grads(model_cfg, tcfg: TrainConfig, params, batch):
    """One rank's (flat grads, metrics) on its batch shard."""
    leaves = [x.detach().requires_grad_(True) for x in T.flatten(params)]
    tree = T.unflatten(params, leaves)
    A = tcfg.accum_steps
    if A == 1:
        loss, metrics = TF.loss_fn(tree, model_cfg, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        return grads, {k: v.detach() for k, v in metrics.items()}
    mbs = {k: v.reshape((A, v.shape[0] // A) + tuple(v.shape[1:]))
           for k, v in batch.items()}
    g_acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
             for x in leaves]
    me_acc: Dict[str, torch.Tensor] = {}
    for a in range(A):
        loss, me = TF.loss_fn(tree, model_cfg, {k: v[a] for k, v in mbs.items()})
        for acc, g in zip(g_acc, torch.autograd.grad(loss, leaves)):
            acc += g.to(torch.float32)
        for k, v in me.items():
            me_acc[k] = me_acc.get(k, 0.0) + v.detach().to(torch.float32)
    return [g / A for g in g_acc], {k: v / A for k, v in me_acc.items()}


def make_train_step(model_cfg, tcfg: TrainConfig, dp, params_shapes,
                    device="cuda"):
    """Returns ``(step, info, layout)``.

    ``dp`` gives the sizes of ``tcfg.dp_axes`` (:func:`dp_shape`: an int
    for one axis); the ranks are stacked row-major over them.
    ``step(params, state, batch) -> (params, state, metrics)``: ``params`` a
    list of ``n_dp`` per-rank trees, ``batch`` the global batch (numpy or
    tensors, ``[B, T]``) split over the ranks along dim 0.  The step
    updates ``state``'s optimizer and error-feedback buffers in place: hand
    the state over, as the reference step donates it.  ``info`` holds the
    static ``bucket_plan`` (None = per-leaf collectives)."""
    dev = resolve_device(device)
    shape = dp_shape(tcfg, dp)
    n_dp = int(np.prod(shape))
    if n_dp > 1 and not executable_at(tcfg.backend, n_dp):
        raise ValueError(
            f"backend={tcfg.backend!r} cannot execute at non-power-of-"
            f"two n_dp={n_dp} (butterfly schedules need pow2 rank counts); "
            f"use backend='ring' or 'xla'")
    layout = zero.zero_layout(model_cfg, params_shapes, n_dp)
    plan = resolve_bucket_plan(tcfg, n_dp, params_shapes, layout)
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
    flat_zd = T.flatten(layout)

    def step(params, state, batch):
        flat_p = [T.flatten(tr) for tr in params]
        flat_opt = T.flatten_up_to(params[0], state["opt"])
        step_no = state["step"]
        nleaf = len(flat_zd)

        # ---- forward/backward, one rank after another ----
        grads: List[List[Optional[torch.Tensor]]] = []
        mets = []
        shards = {k: torch.as_tensor(np.asarray(v)).to(dev).chunk(n_dp)
                  for k, v in batch.items()}
        for r in range(n_dp):
            g, m = _rank_grads(model_cfg, tcfg, params[r],
                               {k: v[r] for k, v in shards.items()})
            grads.append(g)
            mets.append(m)

        def take(i):
            """Leaf i's gradients stacked [p, ...]; the ranks' copies go."""
            g = torch.stack([grads[r][i] for r in range(n_dp)])
            for r in range(n_dp):
                grads[r][i] = None
            return g

        # ---- DP gradient reduce-scatter ----
        post = _post_reduce_div(tcfg, n_dp)
        g_sh: List[Optional[torch.Tensor]] = [None] * nleaf
        new_ef: Dict[str, torch.Tensor] = {}
        if plan is None:
            for i, zd in enumerate(flat_zd):
                g_sh[i] = _rs_leaf(tcfg, take(i), zd, shape).to(
                    torch.float32) / post
        else:
            for i in plan.replicated:
                g_sh[i] = _rs_leaf(tcfg, take(i), -1, shape).to(
                    torch.float32) / post
            for bucket, (rs_b, rs_w, _, _) in zip(plan.buckets, decisions):
                v = None
                for r in range(n_dp):
                    row = buckets.pack_bucket(
                        bucket, [_bucket_wire_cast(rs_w, grads[r][s.index],
                                                   n_dp)
                                 for s in bucket.slots], n_dp)
                    if v is None:
                        v = torch.empty((n_dp,) + tuple(row.shape),
                                        dtype=row.dtype, device=row.device)
                    v[r] = row
                    del row
                    for s in bucket.slots:   # this rank's grads are packed
                        grads[r][s.index] = None
                if rs_w == "int8":
                    # error feedback: the codec's quantization error rides
                    # into next step's gradient
                    bid = str(bucket.bid)
                    v, new_ef[bid] = comp.ef_compress(v, state["ef"][bid],
                                                      codec="wire_int8")
                    row = _rs_bucket_q(rs_b, v)
                else:
                    row = _rs_bucket(rs_b, v, shape)
                del v
                row = row.to(torch.float32) / _bucket_post(rs_w, n_dp)
                for s, view in zip(bucket.slots,
                                   buckets.shard_views(bucket, row, n_dp)):
                    g_sh[s.index] = view

        # ---- grad-norm + metrics: ONE stacked small allreduce ----
        def sq(g):
            return torch.sum(torch.square(g), dim=tuple(range(1, g.dim())))

        zeros = torch.zeros(n_dp, dtype=torch.float32, device=dev)
        sq_shard = sum((sq(g) for g, zd in zip(g_sh, flat_zd) if zd >= 0),
                       zeros)
        sq_repl = sum((sq(g) for g, zd in zip(g_sh, flat_zd) if zd < 0),
                      zeros)
        mkeys = sorted(mets[0])
        vec = torch.stack(
            [sq_shard] + [torch.stack([m[k] for m in mets]).to(torch.float32)
                          for k in mkeys], dim=1)
        red = _small_allreduce(tcfg, vec)
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
                new_p[r][i] = stacked_leaf[r]

        if plan is None:
            for i, zd in enumerate(flat_zd):
                scatter_ranks(i, _ag_leaf(tcfg, upd(i), zd, shape))
        else:
            for i in plan.replicated:
                scatter_ranks(i, upd(i))
            for bucket, (_, _, ag_b, ag_w) in zip(plan.buckets, decisions):
                packed = buckets.pack_shards(
                    bucket, [upd(s.index) for s in bucket.slots], lead=1)
                if ag_w == "int8":
                    full = _ag_bucket_q(ag_b, packed).to(
                        getattr(torch, bucket.dtype))
                else:
                    full = _ag_bucket(ag_b, packed, shape)
                del packed
                for r in range(n_dp):
                    for s, leaf in zip(bucket.slots, buckets.unpack_bucket(
                            bucket, full[r], n_dp)):
                        new_p[r][s.index] = leaf
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

    return step, {"bucket_plan": plan, "decisions": decisions}, layout
