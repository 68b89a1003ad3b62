"""``predict_time``: the α-β/contention cost engine behind backend="auto".

Maps an API-level backend name (what ``collectives.api`` dispatches on) to
the exact per-step schedule ``core.schedules`` would execute for it at a
given vector size, then prices that schedule on a topology with the
contention-aware models from ``core.traffic`` (``sched_time`` for grouped
topologies, ``torus_time`` for tori).

The small/large switch mirrors ``collectives.api``: vectors of
``nbytes <= small_cutoff_bytes`` (inclusive boundary) run the small-vector
variants (full-vector recursive doubling for allreduce, plain trees for
broadcast/reduce), larger ones the scatter/allgather composites.

The ``xla`` backend cannot be scheduled step-by-step from here, so it is
priced through documented proxies: XLA's allreduce/reduce-scatter/allgather
lowering on a torus is ring-based, its alltoall is linear (Bruck-priced),
and its rooted collectives are emulated in ``collectives.api`` via masked
psum (priced as a recursive-doubling allreduce).  Proxies are good enough
for benchmark comparison; ``xla`` is intentionally *not* in ``CANDIDATES``,
the set the decision table minimizes over, so model error in the proxies
can never leak into auto-selection.

Besides the wire time, every backend is charged a **local memory term**:
each step's received payload crosses HBM ``passes`` times before the next
step can send (the slice/add/concat chain of the shmap lowering —
``UNFUSED_HBM_PASSES``), except for ``pallas_fused``, whose fused step
kernels make a single pass (``FUSED_HBM_PASSES``); its small-allreduce
regime falls back to the unfused shmap path and is priced accordingly.
``pallas_fused`` executes the bine schedule, so its wire time equals
bine's; it additionally pays ``FUSED_STEP_OVERHEAD_S`` per step (one
kernel launch per schedule step), so the decision tables pick it exactly
where the saved HBM passes beat that overhead — the large-payload
buckets — while the latency-bound small buckets stay with the plain
backends.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple, Union

from repro_torch.core.schedules import Sched, get_schedule
from repro_torch.core.traffic import (GroupedTopo, TorusTopo, msg_bytes,
                                sched_time, torus_time)

#: default small/large switch, kept in sync with CollectiveConfig
SMALL_CUTOFF_BYTES = 16384

#: the reference's HBM rate for the local-memory term (TPU v5e, as its
#: launch.hlo has it): the default of every ``hbm_bw`` parameter below
HBM_BW = 819e9

#: HBM round trips of one step's received payload: the unfused shmap chain
#: materializes the kept slice, the reduction, and the repack; the fused
#: Pallas step kernel streams all three in one pass.
UNFUSED_HBM_PASSES = 3.0
FUSED_HBM_PASSES = 1.0

#: per-step kernel-launch overhead of the fused path (one custom-call per
#: schedule step).  This is what keeps the latency-bound small buckets
#: with the plain backends: the fused pass only wins once the saved HBM
#: round trips outweigh a kernel launch per step.
FUSED_STEP_OVERHEAD_S = 1.0e-6

#: backends executed by ``kernels.collectives`` fused step kernels
FUSED_BACKENDS = ("pallas_fused",)

#: collectives / backends that can put a compressed dtype on the wire.
#: int8/bf16 wire is implemented for the butterfly reduce-scatter and
#: allgather paths only (``collectives.stacked.reduce_scatter_q`` /
#: ``allgather_q`` and the fused ``kernels.collectives.ops`` twins);
#: everything else stays float32.
WIRE_CODEC_COLLECTIVES = ("reduce_scatter", "allgather")
WIRE_CODEC_BACKENDS = ("bine", "recdoub", "pallas_fused")

#: extra HBM round trips the *unfused* shmap codec path pays per step:
#: the quantized send and the dequantized recv are materialized as
#: separate HLO values.  The fused step kernels fold encode/decode into
#: the same single pass as the reduction, so they pay none.
CODEC_HBM_PASSES = 2.0

#: per-step codec compute overhead (scale reduction + rounding), charged
#: whenever a non-f32 wire dtype is in play.  Keeps tiny latency-bound
#: payloads on float32: the bandwidth saved must outweigh the codec work.
CODEC_STEP_OVERHEAD_S = 5.0e-7

#: HBM round trips of one AdamW step on a gradient shard: read g/m/v/master,
#: write m/v/master, write the wire-dtype new param, plus the mhat/vhat
#: normalization traffic — the local work a bucket's allgather overlaps.
ADAMW_HBM_PASSES = 10.0

#: candidate gradient-bucket capacities (bytes) the per-topology sweep
#: minimizes over: 256 KiB .. 64 MiB in powers of two
BUCKET_SIZE_CANDIDATES: Tuple[int, ...] = tuple(1 << k for k in range(18, 27))

#: representative full-gradient payload the bucket sweep amortizes over
#: (the argmin is insensitive to it once total >> bucket)
BUCKET_SWEEP_TOTAL_BYTES = 1 << 30

#: (collective, backend) -> (schedule collective, small algo, large algo)
#: — the schedule collective differs from the API collective only for the
#: xla emulation proxies.
_SCHED_ALGO: Dict[Tuple[str, str], Tuple[str, str, str]] = {
    ("allreduce", "bine"): ("allreduce", "bine_small", "bine"),
    ("allreduce", "recdoub"): ("allreduce", "recdoub_small", "recdoub"),
    ("allreduce", "ring"): ("allreduce", "ring", "ring"),
    ("allreduce", "xla"): ("allreduce", "ring", "ring"),
    ("allreduce", "pallas_fused"): ("allreduce", "bine_small", "bine"),
    ("allreduce", "bine_hier"): ("allreduce", "bine_small", "bine_hier"),

    ("reduce_scatter", "bine"): ("reduce_scatter", "bine", "bine"),
    ("reduce_scatter", "recdoub"): ("reduce_scatter", "recdoub", "recdoub"),
    ("reduce_scatter", "ring"): ("reduce_scatter", "ring", "ring"),
    ("reduce_scatter", "xla"): ("reduce_scatter", "ring", "ring"),
    ("reduce_scatter", "pallas_fused"): ("reduce_scatter", "bine", "bine"),
    ("reduce_scatter", "bine_hier"): ("reduce_scatter", "bine_hier",
                                      "bine_hier"),

    ("allgather", "bine"): ("allgather", "bine", "bine"),
    ("allgather", "recdoub"): ("allgather", "recdoub", "recdoub"),
    ("allgather", "ring"): ("allgather", "ring", "ring"),
    ("allgather", "xla"): ("allgather", "ring", "ring"),
    ("allgather", "pallas_fused"): ("allgather", "bine", "bine"),
    ("allgather", "bine_hier"): ("allgather", "bine_hier", "bine_hier"),

    ("alltoall", "bine"): ("alltoall", "bine", "bine"),
    ("alltoall", "recdoub"): ("alltoall", "recdoub", "recdoub"),
    ("alltoall", "bruck"): ("alltoall", "bruck", "bruck"),
    ("alltoall", "ring"): ("alltoall", "bruck", "bruck"),
    ("alltoall", "xla"): ("alltoall", "bruck", "bruck"),

    ("broadcast", "bine"): ("broadcast", "bine", "bine_large"),
    ("broadcast", "recdoub"): ("broadcast", "binomial_dh", "binomial_large"),
    ("broadcast", "xla"): ("allreduce", "recdoub_small", "recdoub"),

    ("reduce", "bine"): ("reduce", "bine", "bine_large"),
    ("reduce", "recdoub"): ("reduce", "binomial_dh", "binomial_large"),
    ("reduce", "xla"): ("allreduce", "recdoub_small", "recdoub"),

    ("gather", "bine"): ("gather", "bine", "bine"),
    ("gather", "recdoub"): ("gather", "binomial", "binomial"),
    ("gather", "xla"): ("allgather", "recdoub", "recdoub"),

    ("scatter", "bine"): ("scatter", "bine", "bine"),
    ("scatter", "recdoub"): ("scatter", "binomial", "binomial"),
    ("scatter", "xla"): ("allreduce", "recdoub_small", "recdoub"),
}

#: backends the decision table minimizes over, per collective.  Every name
#: is dispatchable by ``collectives.api`` (for the rooted collectives,
#: "recdoub" selects the classical binomial-tree family there).
CANDIDATES: Dict[str, Tuple[str, ...]] = {
    # bine_hier LAST: the argmin breaks ties toward earlier candidates,
    # so identity-placement cells (where the composed schedule's bytes
    # equal the flat bine's) keep selecting flat bine and the hierarchy
    # only wins where the preset's grouping makes it strictly cheaper.
    "allreduce": ("bine", "recdoub", "ring", "pallas_fused", "bine_hier"),
    "reduce_scatter": ("bine", "recdoub", "ring", "pallas_fused",
                       "bine_hier"),
    "allgather": ("bine", "recdoub", "ring", "pallas_fused", "bine_hier"),
    "alltoall": ("bine", "recdoub", "bruck"),
    "broadcast": ("bine", "recdoub"),
    "reduce": ("bine", "recdoub"),
    "gather": ("bine", "recdoub"),
    "scatter": ("bine", "recdoub"),
}


def candidates_for(collective: str, topology: str) -> Tuple[str, ...]:
    """``CANDIDATES`` restricted to what ``collectives.api`` can execute
    on this preset: ``bine_hier`` derives its tier stack from a grouped
    preset's hierarchy, so it is not a candidate where none exists.

    The capability is probed through ``presets.tier_split_or_none`` (the
    probe is p-independent, so any rank count works) instead of
    string-matching preset names — a new hierarchy-free preset drops
    ``bine_hier`` automatically; unknown presets raise ``KeyError``."""
    from .presets import tier_split_or_none

    cands = CANDIDATES[collective]
    if tier_split_or_none(topology, 2) is None:
        cands = tuple(b for b in cands if b != "bine_hier")
    return cands


def wire_candidates(collective: str,
                    topology: str) -> Tuple[Tuple[str, str], ...]:
    """``(backend, wire_dtype)`` pairs the joint argmin minimizes over.

    Every plain backend candidate at float32 comes first (so ties break
    toward the uncompressed wire, exactly like the backend-only table),
    then the codec-capable backends at bfloat16 and int8 — but only for
    the collectives the codec paths implement (``WIRE_CODEC_COLLECTIVES``).
    """
    cands = candidates_for(collective, topology)
    pairs = [(b, "float32") for b in cands]
    if collective in WIRE_CODEC_COLLECTIVES:
        for wire in ("bfloat16", "int8"):
            pairs.extend((b, wire) for b in cands
                         if b in WIRE_CODEC_BACKENDS)
    return tuple(pairs)


def schedule_algo(collective: str, backend: str, nbytes: float,
                  small_cutoff_bytes: int = SMALL_CUTOFF_BYTES
                  ) -> Tuple[str, str]:
    """(schedule collective, algo name) that ``backend`` would execute."""
    try:
        sched_coll, small, large = _SCHED_ALGO[(collective, backend)]
    except KeyError:
        raise ValueError(
            f"no cost model for backend {backend!r} on {collective!r}")
    return sched_coll, (small if nbytes <= small_cutoff_bytes else large)


@lru_cache(maxsize=4096)
def _cached_schedule(collective: str, algo: str, p: int) -> Sched:
    return get_schedule(collective, algo, p)


def hbm_passes(backend: str, algo: str) -> float:
    """Per-step HBM round trips of the received payload for this backend.

    ``pallas_fused`` makes one pass (the fused step kernel), except in the
    small-allreduce regime where it falls back to the unfused shmap path.
    """
    if backend in FUSED_BACKENDS and not algo.endswith("_small"):
        return FUSED_HBM_PASSES
    return UNFUSED_HBM_PASSES


def _local_mem_time(sched: Sched, p: int, nbytes: float,
                    passes: float, hbm_bw: float = HBM_BW) -> float:
    """Bulk-synchronous local-memory term: per step, the slowest rank's
    received bytes cross HBM ``passes`` times (at ``hbm_bw`` B/s) before
    the next step."""
    t = 0.0
    for step in sched:
        per_rank: Dict[int, float] = {}
        for m in step:
            per_rank[m.dst] = per_rank.get(m.dst, 0.0) + msg_bytes(
                m, p, nbytes)
        if per_rank:
            t += passes * max(per_rank.values()) / hbm_bw
    return t


def _wire_scale(collective: str, backend: str, wire_dtype: str) -> float:
    """Wire-byte multiplier for ``wire_dtype``, validating the combo.

    float32 is always 1.0; a compressed wire is only meaningful on the
    collective/backend pairs that implement the codec paths.
    """
    if wire_dtype == "float32":
        return 1.0
    from repro_torch.collectives.compression import WIRE_DTYPES, wire_factor
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire_dtype!r}; expected one "
                         f"of {WIRE_DTYPES}")
    if (collective not in WIRE_CODEC_COLLECTIVES
            or backend not in WIRE_CODEC_BACKENDS):
        raise ValueError(
            f"wire_dtype={wire_dtype!r} is not implemented for "
            f"({collective!r}, backend={backend!r}); codec wires exist for "
            f"{WIRE_CODEC_COLLECTIVES} on {WIRE_CODEC_BACKENDS}")
    return wire_factor(wire_dtype)


def predict_time(collective: str, backend: str, p: int, nbytes: float,
                 topo: Union[GroupedTopo, TorusTopo],
                 small_cutoff_bytes: int = SMALL_CUTOFF_BYTES,
                 wire_dtype: str = "float32",
                 hbm_bw: float = HBM_BW) -> float:
    """Modeled completion time (seconds) of one collective invocation.

    Wire time (α-β/contention) plus the local-memory term (see module
    docstring).  ``nbytes`` is the *full-vector* payload (the convention
    of ``core.traffic.msg_bytes``); ``p`` must be a power of two, like
    every schedule in ``core.schedules``.

    ``wire_dtype`` compresses the wire only: the schedule is unchanged
    (size-regime switching still keys on the float32 ``nbytes``) and the
    β term sees ``nbytes × wire_factor``, while the local term still
    moves float32 payloads through HBM — plus the codec charge: the
    unfused shmap codec path materializes encode/decode as
    ``CODEC_HBM_PASSES`` extra round trips, the fused kernels fold them
    into their single pass, and both pay ``CODEC_STEP_OVERHEAD_S`` per
    step.  At float32 the result is bit-for-bit the pre-codec model.
    ``hbm_bw`` is the local memory's rate in B/s.
    """
    wscale = _wire_scale(collective, backend, wire_dtype)
    sched_coll, algo = schedule_algo(collective, backend, nbytes,
                                     small_cutoff_bytes)
    sched = _cached_schedule(sched_coll, algo, p)
    if isinstance(topo, TorusTopo):
        wire = torus_time(sched, p, float(nbytes) * wscale, topo)
    else:
        wire = sched_time(sched, p, float(nbytes) * wscale, topo)
    passes = hbm_passes(backend, algo)
    local = _local_mem_time(sched, p, float(nbytes), passes, hbm_bw)
    if passes == FUSED_HBM_PASSES:
        local += FUSED_STEP_OVERHEAD_S * len(sched)
    if wire_dtype != "float32":
        if passes != FUSED_HBM_PASSES:
            local += _local_mem_time(sched, p, float(nbytes),
                                     CODEC_HBM_PASSES, hbm_bw)
        local += CODEC_STEP_OVERHEAD_S * len(sched)
    return wire + local


# ---------------------------------------------------------------------------
# Gradient-bucket sizing (train/buckets.py)
# ---------------------------------------------------------------------------

def _best_time(collective: str, p: int, nbytes: float, topo,
               small_cutoff_bytes: int, hbm_bw: float = HBM_BW) -> float:
    """Fastest candidate backend's predicted time — what an auto-resolved
    bucket of this size would actually pay."""
    return min(predict_time(collective, b, p, nbytes, topo,
                            small_cutoff_bytes, hbm_bw=hbm_bw)
               for b in CANDIDATES[collective])


def predict_bucket_time(p: int, bucket_bytes: int, total_bytes: float,
                        topo: Union[GroupedTopo, TorusTopo],
                        small_cutoff_bytes: int = SMALL_CUTOFF_BYTES,
                        hbm_bw: float = HBM_BW) -> float:
    """Modeled grad-exchange time for one train step at a bucket size.

    Pipeline model of the bucketed gradient path (``train/step.py``):
    every bucket pays a reduce-scatter, then the AdamW update of bucket
    ``i`` is independent dataflow from the allgather of bucket ``i-1``,
    so all updates except the pipeline-fill one hide behind allgathers::

        T(b) = N·t_rs(b) + t_upd(b) + (N-1)·max(t_ag(b), t_upd(b)) + t_ag(b)

    with ``N = ceil(total/b)`` and ``t_upd`` the AdamW HBM traffic of one
    bucket's 1/p shard.  Small buckets lose to the per-bucket α·log₂(p)
    latency (step count × α); one giant bucket exposes its whole update
    with nothing to overlap — the sweep finds the knee.
    """
    import math as _m
    n = max(1, int(_m.ceil(float(total_bytes) / bucket_bytes)))
    t_rs = _best_time("reduce_scatter", p, bucket_bytes, topo,
                      small_cutoff_bytes, hbm_bw)
    t_ag = _best_time("allgather", p, bucket_bytes, topo,
                      small_cutoff_bytes, hbm_bw)
    t_upd = ADAMW_HBM_PASSES * (bucket_bytes / p) / hbm_bw
    return n * t_rs + t_upd + (n - 1) * max(t_ag, t_upd) + t_ag


def optimal_bucket_bytes(p: int,
                         topo: Union[GroupedTopo, TorusTopo],
                         total_bytes: float = BUCKET_SWEEP_TOTAL_BYTES,
                         candidates: Tuple[int, ...] = BUCKET_SIZE_CANDIDATES,
                         small_cutoff_bytes: int = SMALL_CUTOFF_BYTES,
                         hbm_bw: float = HBM_BW) -> int:
    """Argmin of ``predict_bucket_time`` over the candidate capacities.

    Deterministic: ties break toward the smaller capacity (earlier
    candidate).  Cached per topology/p in the decision tables by
    ``table.build_table`` so production tracing never re-sweeps.
    """
    return min(candidates,
               key=lambda b: predict_bucket_time(p, b, total_bytes, topo,
                                                 small_cutoff_bytes, hbm_bw))
