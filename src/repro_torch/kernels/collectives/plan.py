"""Static emission plans: fused vs unfused op/byte accounting per schedule.

For one collective invocation this module enumerates, step by step, the
HLO-level ops each execution path emits and the HBM bytes they touch,
using the same conventions as ``launch.hlo.module_bytes`` (op charge =
operands + result; dynamic-slice / dynamic-update-slice = 2 x the slice):

  * **unfused** — the ``collectives.shmap`` lowering exactly as written
    (slice / slice / ppermute / add per butterfly RS step; ppermute /
    concat / concat / select per AG step; slice / ppermute / slice / add /
    update per ring step);
  * **fused** — the ``pallas_fused`` lowering, where each step's local
    chain is one kernel (on TPU: one custom-call) whose bytes are its
    block reads + writes, and where the ring paths drop the per-step
    send-slice entirely (the kernel's second output / the previous recv
    is the next send).

The **wire structure is identical by construction** (same schedules, one
ppermute per step, same payload bytes) — ``ppermute_ops`` /
``wire_bytes`` can therefore be validated against the real compiled HLO
of *either* path via ``launch.hlo.analyze_text`` (the fused path's
interpret-mode CPU module still contains the real collective-permutes,
even though the interpreter inflates the local-op count; the TPU
lowering is one custom-call per kernel, which is what the fused numbers
model).  ``benchmarks/bench_fused_collectives.py`` performs that
validation and records both plans in ``BENCH_collectives.json``.

Assumes ``nelems % p == 0`` (the padded case adds one pad concat to both
paths equally) and a power-of-two ``p`` for the butterfly algos.

The PyTorch port's own copy of ``repro.kernels.collectives.plan``: the
plans count the reference's HLO-level emission, which is what the paper's
fused-vs-unfused comparison prices; on Hopper each fused step is one CUDA
kernel launch (``kernel.py``), as one custom-call is on the TPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.negabinary import log2_int

COLLECTIVES = ("reduce_scatter", "allgather", "allreduce")
ALGOS = ("bine", "recdoub", "ring")


@dataclass(frozen=True)
class PathPlan:
    """One execution path's per-rank emission: HLO-level op count, HBM
    bytes touched by the local work, and the (path-invariant) wire side."""
    ops: int
    hbm_bytes: float
    ppermute_ops: int
    wire_bytes: float

    def as_dict(self) -> Dict[str, float]:
        return {"ops": self.ops, "hbm_bytes": self.hbm_bytes,
                "ppermute_ops": self.ppermute_ops,
                "wire_bytes": self.wire_bytes}


def _butterfly_halves(n: int, s: int):
    """Window size after each of the s steps: n/2, n/4, ..., n/2^s."""
    return [n >> (i + 1) for i in range(s)]


def _rs_plans(n: int, s: int, itemsize: int, permuted: bool):
    halves = _butterfly_halves(n, s)
    pre_ops = 1 if permuted else 0
    pre_bytes = 2 * n * itemsize if permuted else 0.0
    wire = sum(h * itemsize for h in halves)
    # unfused step: send slice (2h) + kept slice (2h) + add (3h)
    u_ops = pre_ops + 3 * s
    u_bytes = pre_bytes + sum(7 * h * itemsize for h in halves)
    # fused: first pack slice (2h0) + per-step kernel reading the kept
    # half + recv and writing newbuf (+ the next send q = h/2, all but last)
    f_ops = pre_ops + 1 + s
    f_bytes = pre_bytes + 2 * halves[0] * itemsize
    for i, h in enumerate(halves):
        q = h // 2 if i + 1 < s else 0
        f_bytes += (3 * h + q) * itemsize
    return (PathPlan(u_ops + s, u_bytes, s, wire),
            PathPlan(f_ops + s, f_bytes, s, wire))


def _ag_plans(n: int, s: int, itemsize: int, permuted: bool):
    # windows double: h, 2h, ... with h = n/2^s at the first (reversed) step
    sizes = [n >> (s - i) for i in range(s)]
    post_ops = 1 if permuted else 0
    post_bytes = 2 * n * itemsize if permuted else 0.0
    wire = sum(h * itemsize for h in sizes)
    # unfused step: concat (4h) + concat (4h) + select (6h)
    u_ops = post_ops + 3 * s
    u_bytes = post_bytes + sum(14 * h * itemsize for h in sizes)
    # fused step: one merge kernel reading buf + recv, writing 2h
    f_ops = post_ops + s
    f_bytes = post_bytes + sum(4 * h * itemsize for h in sizes)
    return (PathPlan(u_ops + s, u_bytes, s, wire),
            PathPlan(f_ops + s, f_bytes, s, wire))


def _ring_rs_plans(n: int, p: int, itemsize: int):
    blk = n // p
    steps = p - 1
    wire = steps * blk * itemsize
    # unfused step: send slice (2b) + cur slice (2b) + add (3b) + DUS (2b);
    # final own-block slice on both paths
    u = PathPlan(4 * steps + 1 + steps, (9 * steps + 2) * blk * itemsize,
                 steps, wire)
    # fused: one initial send slice, then per step one kernel (read block +
    # recv, write block + the updated-block second output = next send)
    f_bytes = 2 * blk * itemsize
    for t in range(steps):
        extra = blk if t + 1 < steps else 0   # next-send output
        f_bytes += (3 * blk + extra) * itemsize
    f = PathPlan(1 + steps + 1 + steps, f_bytes + 2 * blk * itemsize,
                 steps, wire)
    return u, f


def _ring_ag_plans(n: int, p: int, itemsize: int):
    blk = n // p
    steps = p - 1
    wire = steps * blk * itemsize
    init_ops, init_bytes = 2, (n + 2 * blk) * itemsize  # zeros + own DUS
    # unfused step: send slice (2b) + DUS (2b)
    u = PathPlan(init_ops + 2 * steps + steps,
                 init_bytes + 4 * steps * blk * itemsize, steps, wire)
    # fused step: one placement kernel (read recv, write block); the next
    # send is the recv itself — no slice
    f = PathPlan(init_ops + steps + steps,
                 init_bytes + 2 * steps * blk * itemsize, steps, wire)
    return u, f


def path_plans(collective: str, algo: str, p: int, nelems: int,
               itemsize: int = 4):
    """(unfused, fused) :class:`PathPlan` for one collective invocation.

    ``nelems`` is the full-vector element count (``% p == 0``).
    """
    if collective not in COLLECTIVES:
        raise ValueError(f"no emission plan for collective {collective!r}")
    if algo not in ALGOS:
        raise ValueError(f"no emission plan for algo {algo!r}")
    assert nelems % p == 0, (nelems, p)
    if algo == "ring":
        if collective == "reduce_scatter":
            return _ring_rs_plans(nelems, p, itemsize)
        if collective == "allgather":
            return _ring_ag_plans(nelems, p, itemsize)
        urs, frs = _ring_rs_plans(nelems, p, itemsize)
        uag, fag = _ring_ag_plans(nelems, p, itemsize)
        return (_concat(urs, uag), _concat(frs, fag))
    s = log2_int(p)
    if collective == "reduce_scatter":
        return _rs_plans(nelems, s, itemsize, permuted=True)
    if collective == "allgather":
        return _ag_plans(nelems, s, itemsize, permuted=True)
    urs, frs = _rs_plans(nelems, s, itemsize, permuted=False)
    uag, fag = _ag_plans(nelems, s, itemsize, permuted=False)
    return (_concat(urs, uag), _concat(frs, fag))


def wire_payload_bytes(collective: str, algo: str, p: int, nelems: int,
                       wire_dtype: str = "float32") -> float:
    """Per-rank wire bytes of one invocation under a wire codec.

    The schedule (and hence the element traffic) is wire-dtype-invariant;
    only the bytes per element change — int8 includes the per-chunk f32
    scale metadata (``compression.WIRE_BYTES_PER_ELEM``).  This is the
    ``wire_bytes_per_step`` accounting ``bench_bucketed_grads.py`` emits.
    """
    from repro_torch.collectives.compression import wire_factor
    unfused, _ = path_plans(collective, algo, p, nelems, itemsize=4)
    return unfused.wire_bytes * wire_factor(wire_dtype)


def _concat(a: PathPlan, b: PathPlan) -> PathPlan:
    return PathPlan(a.ops + b.ops, a.hbm_bytes + b.hbm_bytes,
                    a.ppermute_ops + b.ppermute_ops,
                    a.wire_bytes + b.wire_bytes)


def compare(collective: str, algo: str, p: int, nelems: int,
            itemsize: int = 4) -> Dict:
    """Machine-readable fused-vs-unfused comparison (the dry-run record
    ``benchmarks/bench_fused_collectives.py`` writes to
    ``BENCH_collectives.json``)."""
    unfused, fused = path_plans(collective, algo, p, nelems, itemsize)
    return {
        "collective": collective, "algo": algo, "p": p, "nelems": nelems,
        "itemsize": itemsize,
        "unfused": unfused.as_dict(), "fused": fused.as_dict(),
        "op_reduction": unfused.ops - fused.ops,
        "hbm_bytes_ratio": (fused.hbm_bytes / unfused.hbm_bytes
                            if unfused.hbm_bytes else 1.0),
    }
