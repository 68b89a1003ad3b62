"""Survivor-set rescheduling: rebuild the collective/ZeRO plan at p' = p - k.

Port of ``repro.resilience.elastic`` on the port's collectives API,
topology tables, ZeRO layout, bucket planner, train config and
checkpoints.  When ``k`` DP ranks die permanently (the ``rank_loss``
fault kind), the job does not fall back to flat-ring-or-nothing: this
module re-derives every plan the training step depends on for the
survivor count:

  * **Collective schedules** — the schedule IR's non-pow2 adapters
    (fold / 3-2 elimination in ``core.schedules``) produce oracle-
    conformant bine/recdoub schedules at ANY p', so planning, pricing,
    and traffic accounting keep working on the degraded set.
    *Execution* is a stricter contract: the stacked butterflies run
    power-of-two rank counts only, so a non-pow2 survivor count executes
    through the ``ring``/``xla`` backends
    (``collectives.api.executable_at``) — :func:`elastic_backend` picks
    the requested backend wherever it still executes and the
    bandwidth-optimal ring where it does not.
  * **Tier stacks** — re-derived from the topology preset over the
    degraded occupancy via ``topology.tier_split_or_none``.
  * **ZeRO bucket rows** — ``replan_buckets`` recomputes the zero layout
    and repacks the gradient buckets at ``n_dp = p'``.
  * **Decision tables** — the per-process table cache is invalidated
    (``topology.invalidate_tables``) so backend="auto" re-prices at p'.

Resuming from the last checkpoint under the replanned step is then
bit-identical to a fresh p'-rank run restored from the same checkpoint
(tests/test_torch_elastic.py): checkpoints hold *global* arrays
(``train.step.to_global``), ``train.step.from_global`` re-slices them at
p', and every replanned collective is deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


def survivor_set(p: int, lost: Sequence[int]) -> Tuple[int, ...]:
    """The ranks that remain after losing ``lost`` out of ``range(p)``."""
    if p < 1:
        raise ValueError(f"need p >= 1 ranks, got {p}")
    dead = set()
    for r in lost:
        if not 0 <= r < p:
            raise ValueError(f"lost rank {r} outside range(0, {p})")
        if r in dead:
            raise ValueError(f"lost rank {r} listed twice")
        dead.add(r)
    out = tuple(r for r in range(p) if r not in dead)
    if not out:
        raise ValueError(f"losing all {p} ranks leaves no survivor set")
    return out


def elastic_backend(requested: str, p_new: int) -> str:
    """The backend the survivor set actually executes.

    Keeps ``requested`` wherever it still executes at ``p_new``
    (``collectives.api.executable_at``); otherwise falls back to
    ``"ring"`` — runs at any rank count, bandwidth-optimal, and
    deterministic (the bit-identical-resume contract needs a
    deterministic reduction order, which rules out ``"xla"`` as the
    automatic fallback).
    """
    from repro_torch.collectives.api import executable_at
    if executable_at(requested, p_new):
        return requested
    return "ring"


@dataclass(frozen=True)
class SurvivorPlan:
    """Everything re-derived for the survivor set, in one place."""
    p_old: int
    p_new: int
    lost: Tuple[int, ...]
    survivors: Tuple[int, ...]
    #: what the job was configured with
    requested_backend: str
    #: what the survivors execute (== requested wherever still executable)
    backend: str
    topology: str
    #: tier stack over the degraded occupancy (None: no grouped hierarchy,
    #: e.g. the torus)
    tiers: Optional[Tuple[int, ...]]

    @property
    def degraded(self) -> bool:
        return self.p_new != self.p_old

    @property
    def fell_back(self) -> bool:
        return self.backend != self.requested_backend

    def schedule(self, collective: str, algo: Optional[str] = None):
        """The oracle-conformant IR schedule at ``p_new`` — the non-pow2
        adapters kick in automatically for a degraded count.  ``algo``
        defaults to this plan's backend's schedule family."""
        from repro_torch.core.schedules import get_schedule
        return get_schedule(collective, algo or _schedule_family(self.backend),
                            self.p_new)

    def describe(self) -> dict:
        return {
            "p_old": self.p_old, "p_new": self.p_new,
            "lost": list(self.lost),
            "requested_backend": self.requested_backend,
            "backend": self.backend, "fell_back": self.fell_back,
            "topology": self.topology,
            "tiers": None if self.tiers is None else list(self.tiers),
        }


def _schedule_family(backend: str) -> str:
    """API backend name -> ``core.schedules`` algorithm family."""
    if backend.startswith("bine") or backend == "pallas_fused":
        return "bine"
    if backend == "recdoub":
        return "recdoub"
    return "ring"   # ring itself; xla is priced by its ring proxy


def plan_survivors(p: int, lost: Sequence[int], backend: str = "bine",
                   topology: str = "tpu_multipod") -> SurvivorPlan:
    """Build the survivor-set plan for losing ``lost`` ranks out of ``p``.

    Invalidates the per-process decision-table cache as a side effect so
    backend="auto" call sites re-price at the new rank count (stale
    p-rank tables must not outlive the reschedule).
    """
    survivors = survivor_set(p, lost)
    p_new = len(survivors)
    from repro_torch.topology import invalidate_tables, tier_split_or_none
    tiers = tier_split_or_none(topology, p_new)
    invalidate_tables(topology)
    return SurvivorPlan(
        p_old=p, p_new=p_new, lost=tuple(sorted(lost)), survivors=survivors,
        requested_backend=backend, backend=elastic_backend(backend, p_new),
        topology=topology, tiers=tiers)


def replan_buckets(model_cfg, params_shapes, n_dp: int, capacity_bytes: int,
                   wire_itemsize: float = 4.0):
    """Re-derive (zero layout, bucket plan) for the survivor count.

    Bucket rows are per-rank slices, so the old plan's packing is
    meaningless at p': the layout is recomputed (a dim divisible by the
    OLD n_dp may not divide by the new one — such leaves fall back to the
    replicated group) and the buckets repacked over it.  Deterministic:
    same (shapes, n_dp, capacity) -> the identical plan on every host.
    """
    from repro_torch.train import buckets, zero
    layout = zero.zero_layout(model_cfg, params_shapes, n_dp)
    plan = buckets.plan_buckets(params_shapes, layout, n_dp,
                                capacity_bytes, wire_itemsize)
    return layout, plan


def elastic_train_config(tcfg, p_new: int):
    """A :class:`~repro_torch.train.step.TrainConfig` the survivor set can
    run.

    Swaps in the executable backend for ``p_new`` and drops wire codecs
    that are butterfly-only (int8 / the joint-auto wire) to float32 at a
    non-power-of-two survivor count — a bfloat16 wire is a plain cast and
    survives on any backend.  At a still-pow2 ``p_new`` the config comes
    back unchanged.
    """
    backend = elastic_backend(tcfg.backend, p_new)
    kw = {}
    if backend != tcfg.backend:
        kw["backend"] = backend
    if p_new & (p_new - 1) and tcfg.wire_dtype in ("int8", "auto"):
        kw["wire_dtype"] = "float32"
    return tcfg.replace(**kw) if kw else tcfg


def elastic_restore(path: str, step: int, like, device=None):
    """Checkpoint restore across an elastic CONFIG change, by leaf path.

    ``checkpoint.restore`` is strict: the checkpoint and ``like`` must
    flatten to the same leaves.  An elastic resume breaks that whenever
    the survivor config changes the state LAYOUT, not just its sharding
    — e.g. dropping the int8 wire at a non-pow2 p' removes the per-bucket
    error-feedback buffers (``state["ef"]``) from the train state.  This
    restore matches leaves by the manifest's tree paths instead (written
    with ``tree.keystr``, the reference's labels, so a checkpoint of
    either package matches):

      * a leaf present in both is restored (global shapes must agree),
      * a checkpoint-only leaf is DROPPED (stale state for machinery the
        survivor config no longer runs),
      * a ``like``-only leaf keeps its ``like`` value (state for machinery
        the old config didn't have), so it must hold one: such a leaf on
        the "meta" device raises ``ValueError``.

    ``like`` is a global-layout tree (``train.step.to_global``; tensors
    of any device, "meta" included, or numpy arrays).  A leaf whose
    global shape differs from the checkpoint's raises ``ValueError``.  A restored tensor
    leaf takes ``like``'s dtype and lands on ``device`` if given, else on
    ``like``'s device; a numpy leaf stays numpy.  Returns ``(tree,
    info)`` where ``info`` lists the ``dropped`` and ``kept_init`` paths
    so the resume log can show exactly what crossed the config boundary.
    With identical layouts this is equivalent to the strict restore.
    """
    import json
    import os

    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.train import checkpoint as ckpt

    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = T.flatten_with_path(like)
    like_paths = [T.keystr(p) for p, _ in flat_like]
    ckpt_paths = manifest.get("paths") or []
    if not ckpt_paths or not like_paths:   # no path labels: strict only
        return ckpt.restore(path, step, like, device=device), {
            "dropped": [], "kept_init": []}
    by_path = {p: i for i, p in enumerate(ckpt_paths)}
    flat, kept_init = [], []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for lp, (_, lk) in zip(like_paths, flat_like):
            i = by_path.pop(lp, None)
            if i is None:
                if isinstance(lk, torch.Tensor) and lk.is_meta:
                    raise ValueError(
                        f"{lp}: not in the checkpoint, and `like` holds it "
                        f"on the meta device, with no value to keep")
                flat.append(lk)
                kept_init.append(lp)
                continue
            t = ckpt.load_leaf(data, i, manifest)
            want = tuple(lk.shape) if isinstance(lk, torch.Tensor) \
                else tuple(np.shape(lk))
            if tuple(t.shape) != want:
                raise ValueError(
                    f"{lp}: ckpt {tuple(t.shape)} vs expected {want}")
            if isinstance(lk, torch.Tensor):
                flat.append(t.to(device if device is not None
                                 else lk.device, lk.dtype))
            else:
                if t.dtype == torch.bfloat16:
                    raise TypeError(f"{lp}: a bfloat16 leaf restores into a "
                                    "tensor, not a numpy array")
                flat.append(t.numpy().astype(np.asarray(lk).dtype))
    return T.unflatten(like, flat), {"dropped": sorted(by_path),
                                     "kept_init": kept_init}
