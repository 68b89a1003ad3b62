"""The training step: DP ranks stacked on one device, Bine gradient
collectives, ZeRO-1 AdamW.

Port of ``repro.train.step`` (model axis 1, one DP axis).  The reference
runs the step body under ``shard_map`` on p devices; here the p ranks run
on one device:

  * every rank holds its own parameters — ``params`` is a list of p trees —
    and runs forward and backward on its own batch shard, one rank after
    another;
  * gradients, optimizer shards, error-feedback residuals and collective
    buffers are stacked ``[p, ...]``, and every collective runs over that
    rank axis (``collectives.stacked`` for ``backend="bine"``,
    ``kernels.collectives.ops`` — the CUDA step kernels — for
    ``"pallas_fused"``).

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
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.collectives import compression as comp
from repro_torch.collectives import stacked
from repro_torch.kernels.collectives import ops as fused
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import (AdamWConfig, adamw_init_leaf,
                                     adamw_update_leaf, lr_at)
from repro_torch.train import buckets, zero

#: wire dtypes the reference accepts; "auto" is not ported yet
WIRE_DTYPES = ("float32", "bfloat16", "int8", "auto")

#: backends this port runs, and where each missing one is queued
BACKENDS = ("bine", "pallas_fused")
_NOT_PORTED = {
    "auto": "ROADMAP.md queue A item 1 (api.py dispatch + auto)",
    "recdoub": "ROADMAP.md queue A item 1 (api.py dispatch + auto)",
    "xla": "ROADMAP.md queue A item 1 (api.py dispatch + auto)",
    "ring": "ROADMAP.md queue A item 2 (the ring family with kernel 4)",
    "bine_hier": "ROADMAP.md queue A item 2 (the ring family and "
                 "composed schedules)",
}


@dataclass(frozen=True)
class TrainConfig:
    """The reference's config less what the port does not run yet: one DP
    axis (the stacked ranks), model axis 1, analytic tables only."""
    backend: str = "bine"            # bine | pallas_fused
    accum_steps: int = 1
    clip_norm: float = 1.0
    #: gradient/param wire: float32 | bfloat16 (cast) | int8 (pow2-scale
    #: wire codec + error feedback, bucketed path only)
    wire_dtype: str = "float32"
    adamw: AdamWConfig = AdamWConfig()
    #: preset whose bucket capacity bucket_bytes=-1 reads
    topology: str = "tpu_multipod"
    #: small/large allreduce switch (inclusive), bytes of the wire dtype
    small_cutoff_bytes: int = 16384
    #: -1: the topology preset's capacity, 0: per-leaf, >0: bytes
    bucket_bytes: int = -1

    def __post_init__(self):
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unsupported wire_dtype {self.wire_dtype!r}: expected one "
                f"of {WIRE_DTYPES}")
        if self.backend in _NOT_PORTED:
            raise NotImplementedError(
                f"backend {self.backend!r} is not ported: "
                f"{_NOT_PORTED[self.backend]}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.wire_dtype == "auto":
            raise NotImplementedError(
                "wire_dtype='auto' needs the decision tables: "
                + _NOT_PORTED["auto"])
        if self.wire_dtype == "int8" and self.bucket_bytes == 0:
            raise ValueError(
                "wire_dtype='int8' runs on the bucketed flat-vector "
                "path; bucket_bytes=0 disables bucketing")

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Gradient collectives (bucketed flat + per-leaf dim-general), stacked
# ---------------------------------------------------------------------------

def _wire_cast(tcfg: TrainConfig, g, n_dp: int):
    """One leaf to the wire dtype (per-leaf/replicated path): bf16 is
    pre-scaled by the exact ``1/n_dp`` before the reduce."""
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


def _rs_leaf(tcfg: TrainConfig, g, zd: int, n_dp: int):
    """Reduce ``g [p, ...]`` over the ranks; scatter along zd, or a full
    allreduce when zd < 0."""
    wire = _wire_cast(tcfg, g, n_dp)
    if zd < 0:
        per_rank = wire[0].numel() * wire.element_size()
        if per_rank <= tcfg.small_cutoff_bytes:    # inclusive boundary
            return stacked.allreduce_small(wire, "bine")
        if tcfg.backend == "pallas_fused":
            return fused.allreduce(wire, "bine")
        return stacked.allreduce_butterfly(wire, "bine")
    if tcfg.backend == "pallas_fused":
        return fused.reduce_scatter_dim(wire, zd, "bine")
    return stacked.reduce_scatter_dim(wire, zd, "bine")


def _ag_leaf(tcfg: TrainConfig, x, zd: int):
    if zd < 0:
        return x
    if tcfg.backend == "pallas_fused":
        return fused.allgather_dim(x, zd, "bine")
    return stacked.allgather_dim(x, zd, "bine")


def _rs_bucket(backend: str, v):
    if backend == "pallas_fused":
        return fused.reduce_scatter(v, "bine")
    return stacked.reduce_scatter(v, "bine")


def _ag_bucket(backend: str, row):
    if backend == "pallas_fused":
        return fused.allgather(row, "bine")
    return stacked.allgather(row, "bine")


def _rs_bucket_q(backend: str, v):
    if backend == "pallas_fused":
        return fused.reduce_scatter_q(v, "bine")
    return stacked.reduce_scatter_q(v, "bine")


def _ag_bucket_q(backend: str, row):
    if backend == "pallas_fused":
        return fused.allgather_q(row, "bine")
    return stacked.allgather_q(row, "bine")


def resolve_bucket_plan(tcfg: TrainConfig, n_dp: int, params_shapes,
                        layout) -> Optional[buckets.BucketPlan]:
    """The step's static bucket plan (None = bucketing off).  Capacity:
    ``bucket_bytes`` > 0 verbatim, -1 the topology preset's entry, 0 or
    one rank turns bucketing off."""
    if n_dp <= 1 or tcfg.bucket_bytes == 0:
        return None
    cap = tcfg.bucket_bytes
    if cap < 0:
        from repro_torch.topology import select_bucket_bytes
        cap = select_bucket_bytes(n_dp, tcfg.topology)
    wire_itemsize = comp.WIRE_BYTES_PER_ELEM[tcfg.wire_dtype]
    plan = buckets.plan_buckets(params_shapes, layout, n_dp, cap,
                                wire_itemsize)
    return plan if plan.buckets else None


def bucket_decisions(tcfg: TrainConfig, plan: buckets.BucketPlan):
    """Static per-bucket ``(rs_backend, rs_wire, ag_backend, ag_wire)``.
    The allgather wire only goes int8; a bf16 wire gathers params at
    their own dtype."""
    ag_w = "int8" if tcfg.wire_dtype == "int8" else "float32"
    return [(tcfg.backend, tcfg.wire_dtype, tcfg.backend, ag_w)
            for _ in plan.buckets]


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


def init_train_state(model_cfg, tcfg: TrainConfig, params: List[Any],
                     n_dp: int):
    """Optimizer state from the ranks' parameters: per leaf, every rank's
    ``zero_dim`` slice stacked ``[p, ...]`` (the whole leaf if replicated)."""
    layout = zero.zero_layout(model_cfg, params[0], n_dp)
    flats = [T.flatten(tr) for tr in params]
    opt = []
    for i, zd in enumerate(T.flatten(layout)):
        opt.append(adamw_init_leaf(torch.stack(
            [zero.slice_leaf(flats[r][i], zd, n_dp, r) for r in range(n_dp)])))
    device = flats[0][0].device
    state = {"opt": T.unflatten(params[0], opt),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    ef = _ef_init(tcfg, resolve_bucket_plan(tcfg, n_dp, params[0], layout),
                  device)
    if ef:
        state["ef"] = ef
    return state


def make_init_fns(model_cfg, tcfg: TrainConfig, n_dp: int, device="cuda"):
    """(init_params(seed) -> p per-rank trees, init_state(params) -> state).
    Every rank starts from the same weights, each in its own copy."""
    dev = resolve_device(device)

    def init_p(seed: int = 0):
        one = TF.init_params(model_cfg, seed, dev)
        return [one] + [T.tree_map(torch.clone, one) for _ in range(n_dp - 1)]

    def init_s(params):
        return init_train_state(model_cfg, tcfg, params, n_dp)

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


def make_train_step(model_cfg, tcfg: TrainConfig, n_dp: int, params_shapes,
                    device="cuda"):
    """Returns ``(step, info, layout)``.

    ``step(params, state, batch) -> (params, state, metrics)``: ``params`` a
    list of ``n_dp`` per-rank trees, ``batch`` the global batch (numpy or
    tensors, ``[B, T]``) split over the ranks along dim 0.  The step
    updates ``state``'s optimizer and error-feedback buffers in place: hand
    the state over, as the reference step donates it.  ``info`` holds the
    static ``bucket_plan`` (None = per-leaf collectives)."""
    dev = resolve_device(device)
    if n_dp & (n_dp - 1):
        raise ValueError(
            f"the butterfly schedules need a power-of-two DP rank count, "
            f"got {n_dp}; the ring fallback is "
            + _NOT_PORTED["ring"])
    layout = zero.zero_layout(model_cfg, params_shapes, n_dp)
    plan = resolve_bucket_plan(tcfg, n_dp, params_shapes, layout)
    if tcfg.wire_dtype == "int8" and plan is None and n_dp > 1:
        raise ValueError("wire_dtype='int8' needs the bucketed path; this "
                         "model has no bucketable (ZeRO-sharded) leaves")
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
                g_sh[i] = _rs_leaf(tcfg, take(i), zd, n_dp).to(
                    torch.float32) / post
        else:
            for i in plan.replicated:
                g_sh[i] = _rs_leaf(tcfg, take(i), -1, n_dp).to(
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
                    row = _rs_bucket(rs_b, v)
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
        red = stacked.allreduce_small(vec, "bine")
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
                scatter_ranks(i, _ag_leaf(tcfg, upd(i), zd))
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
                    full = _ag_bucket(ag_b, packed)
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
