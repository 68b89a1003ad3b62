#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if anything is off:

1. build   — compile the collective step kernels from
             ``src/repro_torch/kernels/collectives/csrc`` with nvcc;
2. kernels — each kernel (rs_step, ag_step, rs_step_q) against its plain
             PyTorch version on the card, BITWISE, at the main path's shape
             (one 64 MiB f32 bucket at p=4: h = 8 Mi elements at step 0),
             with its median time, the plain version's, and its bound;
3. collectives — fused ``ops`` reduce-scatter / allgather / allreduce and
             the int8-wire pair against the plain ``stacked`` executor,
             bitwise, at p in {4, 8} on 64 MiB f32 vectors;
4. train   — a small reference first (reduced phi4-mini, float32: the card
             against the CPU), then the main path, the cell of
             ``repro_torch/launch/cell.py``: full-width phi4-mini cut to 2
             layers, 4 DP ranks stacked on the card, global batch 8 x 1024
             tokens, ``backend="pallas_fused"``, table bucket size (64 MiB),
             3 float32-wire steps and 2 int8-wire steps, with the kernel
             launch counts read around each run; then one ``bine`` float32
             step from the same start must give the same bits.

Prints a ``kernels:`` summary, one JSON line of per-kernel numbers, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Exits 2 without a result when there is
no CUDA device or no ``src/repro_torch`` beside this file.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM device-memory rate (NVIDIA data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
MiB = 1 << 20
KERNEL_SOURCE = "src/repro_torch/kernels/collectives/csrc/collective_steps.cu"
REPLACES = {
    "rs_step": "src/repro/kernels/collectives/kernel.py:78",
    "ag_step": "src/repro/kernels/collectives/kernel.py:258",
    "rs_step_q": "src/repro/kernels/collectives/kernel.py:166",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` single-call CUDA-event timings, after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, exp) -> float:
    return max(float((g.double() - e.double()).abs().max())
               for g, e in zip(got, exp))


def same_bits(got, exp, what: str) -> None:
    import torch
    for g, e in zip(got, exp):
        check(g.dtype == e.dtype and g.shape == e.shape,
              f"{what}: {g.dtype}{tuple(g.shape)} vs {e.dtype}{tuple(e.shape)}")
        if g.dtype == torch.float32:
            g, e = g.view(torch.int32), e.view(torch.int32)
        elif g.dtype == torch.bfloat16:
            g, e = g.view(torch.int16), e.view(torch.int16)
        check(torch.equal(g, e), f"{what}: kernel differs from plain version")


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(dev):
    import torch
    from repro_torch.collectives import compression as comp
    from repro_torch.core import tables as tb
    from repro_torch.kernels.collectives import kernel as K
    from repro_torch.kernels.collectives import ref as R
    from repro_torch.launch import cell

    p, n = cell.N_DP, 64 * MiB // 4       # one 64 MiB f32 bucket per rank
    h = n // 2
    bt = tb.butterfly_tables("bine_dd", p)
    c = torch.as_tensor(bt.cbit[0], dtype=torch.int32, device=dev)
    cn = torch.as_tensor(bt.cbit[1], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = {}

    def entry(name, kernel_fn, plain_fn, nbytes, variants):
        got, exp = as_tuple(kernel_fn()), as_tuple(plain_fn())
        same_bits(got, exp, name)
        err = max_abs_err(got, exp)
        for what, kf, pf in variants:   # the other dtypes / variants
            same_bits(as_tuple(kf()), as_tuple(pf()), f"{name} {what}")
        torch.cuda.synchronize()
        ms = time_ms(kernel_fn)
        plain_ms = time_ms(plain_fn)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": "bytes",
                      "library_ms": None}
        log(f"  {name}: bitwise OK ({1 + len(variants)} variants); "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({nbytes / MiB:.0f} MiB), library call: none")

    # rs_step, f32 with the next send: reads the kept half and recv, writes
    # new and send
    buf, recv = randn(p, 2 * h), randn(p, h)
    b16, r16 = buf.to(torch.bfloat16), recv.to(torch.bfloat16)
    entry("rs_step", lambda: K.rs_step(buf, recv, c, cn),
          lambda: R.rs_step_ref(buf, recv, c, cn),
          4 * p * (h + h + h + h // 2),
          [("f32 no-send", lambda: K.rs_step(buf, recv, c),
            lambda: R.rs_step_ref(buf, recv, c)),
           ("bf16 send", lambda: K.rs_step(b16, r16, c, cn),
            lambda: R.rs_step_ref(b16, r16, c, cn)),
           ("bf16 no-send", lambda: K.rs_step(b16, r16, c),
            lambda: R.rs_step_ref(b16, r16, c))])

    # ag_step, f32 at the last AG step of the bucket (out [p, 2h])
    a, b = randn(p, h), randn(p, h)
    a16, b16_ = a.to(torch.bfloat16), b.to(torch.bfloat16)
    qa, _ = comp.quantize_wire(a)
    qb, _ = comp.quantize_wire(b)
    entry("ag_step", lambda: K.ag_step(a, b, c), lambda: R.ag_step_ref(a, b, c),
          4 * p * 4 * h,
          [("bf16", lambda: K.ag_step(a16, b16_, c),
            lambda: R.ag_step_ref(a16, b16_, c)),
           ("int8", lambda: K.ag_step(qa, qb, c),
            lambda: R.ag_step_ref(qa, qb, c)),
           ("int8 odd h", lambda: K.ag_step(qa[:, :999].contiguous(),
                                            qb[:, :999].contiguous(), c),
            lambda: R.ag_step_ref(qa[:, :999], qb[:, :999], c))])

    # rs_step_q with the next send: f32 kept half, int8 recv + scales in;
    # f32 new, int8 send + scales out
    rq, rs = comp.quantize_wire(randn(p, h))
    h2 = h // 2
    rq2, rs2 = comp.quantize_wire(randn(p, h2))
    buf2 = randn(p, 2 * h2)
    # a NaN in one codec chunk and an infinity in another of both halves of
    # both kept halves: whatever c and c_next, the send half holds both
    bufn = buf.clone()
    for j in (5, h // 2 + 5, h + 5, h + h // 2 + 5):
        bufn[:, j], bufn[:, j + 256] = float("nan"), float("inf")
    entry("rs_step_q", lambda: K.rs_step_q(buf, rq, rs, c, cn),
          lambda: R.rs_step_ref_q(buf, rq, rs, c, cn),
          p * (4 * h + h + 4 * h // 256 + 4 * h + h // 2 + 4 * h // 2 // 256),
          [("no-send", lambda: K.rs_step_q(buf2, rq2, rs2, cn),
            lambda: R.rs_step_ref_q(buf2, rq2, rs2, cn)),
           ("NaN/inf send", lambda: K.rs_step_q(bufn, rq, rs, c, cn),
            lambda: R.rs_step_ref_q(bufn, rq, rs, c, cn))])
    return rows


# ---------------------------------------------------------------------------
# Phase 3: fused collectives against the plain stacked executor
# ---------------------------------------------------------------------------

def phase_collectives(dev):
    import torch
    from repro_torch.collectives import stacked
    from repro_torch.kernels.collectives import ops

    n = 64 * MiB // 4
    for p in (4, 8):
        gen = torch.Generator(device=dev).manual_seed(p)
        x = torch.randn((p, n), generator=gen, device=dev)
        row = ops.reduce_scatter(x)
        same_bits([row], [stacked.reduce_scatter(x)], f"reduce_scatter p{p}")
        same_bits([ops.allgather(row)], [stacked.allgather(row)],
                  f"allgather p{p}")
        full = ops.allreduce(x)
        same_bits([full], [stacked.allreduce_butterfly(x)], f"allreduce p{p}")
        ref = x.double().sum(0)
        err = float((full[0].double() - ref).abs().max())
        check(err < 1e-4 and all(torch.equal(full[0], full[r])
                                 for r in range(p)),
              f"allreduce p{p} is not the rank sum on every rank ({err})")
        del full
        rq = ops.reduce_scatter_q(x)
        same_bits([rq], [stacked.reduce_scatter_q(x)], f"reduce_scatter_q p{p}")
        same_bits([ops.allgather_q(rq)], [stacked.allgather_q(rq)],
                  f"allgather_q p{p}")
        log(f"  p={p}: reduce_scatter/allgather/allreduce and the int8 pair "
            f"bitwise equal to stacked; allreduce vs f64 sum {err:.2e}")
        del x, row, rq
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4: the train step
# ---------------------------------------------------------------------------

def phase_small_reference(dev):
    """Reduced phi4-mini, float32, p=4, 2 steps: the card (fused kernels)
    against the CPU (plain versions).  Tolerance: loss and grad-norm rtol
    1e-4, params 1e-3 absolute — the model's float32 sums round in another
    order on the two devices (tests/test_torch_train_step.py states why)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import base
    from repro_torch.launch import cell
    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.data import DataConfig, make_batch
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)

    cfg = base.reduced(base.get_config("phi4-mini-3.8b")).replace(
        dtype="float32")
    tcfg = TrainConfig(backend="pallas_fused", bucket_bytes=1 << 16,
                       adamw=AdamWConfig(lr=3e-3, warmup_steps=1,
                                         total_steps=100))
    dcfg = DataConfig(global_batch=8, seq_len=64, vocab_size=cfg.vocab_size)
    out = {}
    p = cell.N_DP
    for where in ("cpu", dev):
        step, _, _ = make_train_step(cfg, tcfg, p, TF.param_shapes(cfg), where)
        init = TF.init_params(cfg, 0, "cpu")
        params = [T.tree_map(lambda x: x.to(where), init) for _ in range(p)]
        state = init_train_state(cfg, tcfg, params, p)
        ms = []
        for s in range(2):
            params, state, m = step(params, state, make_batch(dcfg, s))
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        out[str(where)] = (ms, [x.cpu() for x in T.flatten(params[0])])
    (mc, pc), (mg, pg) = out["cpu"], out[str(dev)]
    for (lc, gc), (lg, gg) in zip(mc, mg):
        check(math.isclose(lc, lg, rel_tol=1e-4)
              and math.isclose(gc, gg, rel_tol=1e-4),
              f"small reference: card {mg} vs cpu {mc}")
    perr = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
    check(perr <= 1e-3, f"small reference: params differ by {perr}")
    log(f"  small reference (reduced, f32): card losses "
        f"{[round(l, 6) for l, _ in mg]} vs cpu {[round(l, 6) for l, _ in mc]}"
        f", params max |diff| {perr:.2e}")


def phase_train(dev):
    import torch
    from repro_torch import tree as T
    from repro_torch.kernels.collectives import kernel as K
    from repro_torch.launch import cell
    from repro_torch.models import transformer as TF
    from repro_torch.train.data import make_batch
    from repro_torch.train.step import make_init_fns, make_train_step

    cfg = cell.model_config()
    shapes = TF.param_shapes(cfg)
    dcfg = cell.data_config(cfg)
    P, B, S = cell.N_DP, dcfg.global_batch, dcfg.seq_len
    log(f"  {cfg.name} cut to {cfg.n_layers} layers: "
        f"{TF.param_count(shapes):,} params, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; dp={P}, batch {B}x{S}")

    def flat_eq(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def run(backend, wire, steps, snapshot=False):
        tcfg = cell.train_config(backend, wire)
        step, info, _ = make_train_step(cfg, tcfg, P, shapes, dev)
        init_p, init_s = make_init_fns(cfg, tcfg, P, dev)
        params = init_p(0)
        state = init_s(params)
        plan = info["bucket_plan"]
        torch.cuda.synchronize()
        K.reset_launches()
        first, times, losses, peaks = None, [], [], []
        for s in range(steps):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, state, m = step(params, state, make_batch(dcfg, s))
            loss = float(m["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            losses.append(loss)
            check(math.isfinite(loss), f"{backend}/{wire} step {s}: loss {loss}")
            flats = [T.flatten(pr) for pr in params]
            check(all(flat_eq(flats[0], flats[r]) for r in range(1, P)),
                  f"{backend}/{wire} step {s}: ranks' params differ")
            if snapshot and s == 0:
                first = [x.clone() for x in flats[0]]
            del flats
            log(f"  {backend}/{wire} step {s}: loss {loss:.6f} gnorm "
                f"{float(m['grad_norm']):.4f} {times[-1] * 1e3:.1f} ms, "
                f"peak {peaks[-1]:.1f} GiB")
        counts = dict(K.LAUNCHES)
        log(f"  {backend}/{wire}: {len(plan.buckets)} buckets "
            f"(capacity {plan.capacity_bytes} B), launches {counts}, "
            f"peak memory {max(peaks):.1f} GiB")
        del params, state
        torch.cuda.empty_cache()
        return counts, losses, times, first

    c32, losses, times, first = run("pallas_fused", "float32", 3,
                                     snapshot=True)
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first loss {losses[0]} is not near ln(V) for random weights")
    steady = statistics.median(times[1:])
    log(f"  pallas_fused/float32 steady step {steady * 1e3:.1f} ms, "
        f"{B * S / steady:.0f} tokens/s")
    c8, _, t8, _ = run("pallas_fused", "int8", 2)
    log(f"  pallas_fused/int8 warm step {t8[1] * 1e3:.1f} ms, "
        f"{B * S / t8[1]:.0f} tokens/s")
    launches = {k: c32[k] + c8[k] for k in c32}
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    check(c8["rs_step_q"] > 0, "the int8 steps did not run rs_step_q")
    cb, _, _, bine_first = run("bine", "float32", 1, snapshot=True)
    check(sum(cb.values()) == 0, f"the bine path launched kernels: {cb}")
    check(flat_eq(first, bine_first),
          "bine and pallas_fused params differ after one float32 step")
    log("  bine float32 step == pallas_fused float32 step, bitwise")
    # steps after the first of each run: warm, so the wires compare
    return launches, {"f32_step_ms": steady * 1e3,
                      "tokens_per_s": B * S / steady,
                      "int8_step_ms": t8[1] * 1e3}


def main() -> int:
    # one 9.8 GB bucket buffer after another: keep the allocator's segments
    # growable so freed ones are reused (set before CUDA starts)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from repro_torch.kernels.collectives import kernel as K

    t_all = time.perf_counter()
    log("[1/4] build")
    t0 = time.perf_counter()
    lib = K.build()
    K._lib()
    log(f"  built {lib.name} in {time.perf_counter() - t0:.1f} s")

    log("[2/4] kernels vs plain versions (bitwise)")
    rows = phase_kernels(dev)
    torch.cuda.empty_cache()

    log("[3/4] fused collectives vs stacked (bitwise)")
    phase_collectives(dev)

    log("[4/4] train")
    phase_small_reference(dev)
    launches, train = phase_train(dev)
    for name, n in launches.items():
        rows[name]["launches"] = n

    log("kernels: [" + ", ".join(f"{k} x{v}" for k, v in launches.items())
        + "]")
    log(f"train: {json.dumps(train)}; total {time.perf_counter() - t_all:.0f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
