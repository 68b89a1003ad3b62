"""Where the time of one train step goes on the card.

Runs the bucketed ZeRO-1 step of the cell in ``launch/cell.py`` (the one
``chip_smoke.py`` drives: full-width phi4-mini cut to 2 layers, 4 DP ranks
stacked on one GPU, batch 8 x 1024), warms up, then profiles 2 steps with
``torch.profiler`` and prints the device time by kernel group (the
butterfly step kernels ``rs_step``, ``rs_step_q`` and ``ag_step`` each a
group of its own), the wall time and the device's idle share, as text and
as one JSON line, for each wire dtype in turn (by default the float32 and
the int8 wire, so both steps' kernels are read in one call).  ``--mesh``
stacks the ranks as the train CLI's does: ``2,2`` is the tensor-parallel
cell (2 DP ranks of 2 TP ranks, ``cell.TP_SHAPE``).  ``--arch`` takes
another arch's train cell (``cell.model_config(arch)``; mixtral-8x7b's
is ``cell.MOE_TRAIN_CELL``, one layer); for a MoE arch it also splits
the MoE layer's device time by phase, forward and backward
(:func:`moe_split`: routing, dispatch, the all_to_all, the experts, the
combine):

  python -m repro_torch.launch.profile_step [--wire-dtype float32 int8] \
      [--mesh 2,2] [--arch mixtral-8x7b]

It uses only the port's public entry points, so the same file runs
against an older tree (``PYTHONPATH=<tree>/src python
src/repro_torch/launch/profile_step.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from collections import defaultdict

import torch

from repro_torch import resolve_device
from repro_torch.launch import cell
from repro_torch.models import transformer as TF
from repro_torch.train.data import make_batch
from repro_torch.train.step import make_init_fns, make_train_step

#: profiled steps after the warm-up, and the kernels listed by name
STEPS, TOP = 2, 12

#: kernel-name patterns -> group, first match wins
GROUPS = (
    ("rs_step_q kernel", ("rs_step_q",)),
    ("rs_step kernel", ("rs_step",)),
    ("ag_step kernel", ("ag_step",)),
    ("rmsnorm kernel", ("rmsnorm_kernel",)),
    ("flash attention kernel", ("flash_kernel",)),
    ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet", "matmul")),
    ("gather/index/copy", ("index", "gather", "scatter", "copy", "cat",
                           "Memcpy", "Memset")),
    ("reduction", ("reduce", "softmax", "norm", "sum", "max")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "elementwise/other"


def moe_split(events, attr: str = "device_time_total") -> dict:
    """The MoE layers' time by phase (``models.moe.PHASES``), ms summed
    over ``events`` (``prof.events()``), as ``"<phase> fwd"`` and
    ``"<phase> bwd"``: a phase's forward is its range's time (the kernels
    of every op under it); a backward op (``autograd::engine::
    evaluate_function: ...``) counts to the phase whose range ran its
    forward op, matched by the autograd sequence number.  ``attr`` is the
    event's time to read (device time; ``cpu_time_total`` on the CPU)."""
    from repro_torch.models.moe import PHASES
    cpu = torch.autograd.DeviceType.CPU
    seq_phase, out = {}, defaultdict(float)
    for ev in events:
        if ev.name not in PHASES or ev.device_type != cpu:
            continue
        out[f"{ev.name} fwd"] += getattr(ev, attr) / 1e3
        stack = list(ev.cpu_children)
        while stack:
            ch = stack.pop()
            if ch.sequence_nr >= 0:
                seq_phase[ch.sequence_nr] = ev.name
            stack.extend(ch.cpu_children)
    for ev in events:
        if ev.name.startswith("autograd::engine::evaluate_function") and \
                ev.sequence_nr in seq_phase:
            out[f"{seq_phase[ev.sequence_nr]} bwd"] += getattr(ev, attr) / 1e3
    return dict(out)


def profile(cfg, backend: str, wire_dtype: str, dev, mesh: str = "4,1"
            ) -> dict:
    """Warm up, then profile ``STEPS`` steps of one wire dtype over the
    ranks of ``mesh`` (``launch.train.parse_mesh``); prints the breakdown
    and returns its JSON record."""
    from repro_torch.launch.train import parse_mesh
    axes, dp, tp = parse_mesh(mesh)
    tcfg = cell.train_config(backend, wire_dtype).replace(dp_axes=axes)
    step, _, _ = make_train_step(cfg, tcfg, dp, TF.param_shapes(cfg), dev,
                                 tp=tp)
    init_p, init_s = make_init_fns(cfg, tcfg, dp, dev, tp=tp)
    params = init_p(0)
    state = init_s(params)
    dcfg = cell.data_config(cfg)
    batches = [make_batch(dcfg, s) for s in range(STEPS + 1)]

    params, state, m = step(params, state, batches[0])     # warm-up
    float(m["loss"])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(1, STEPS + 1):
            params, state, m = step(params, state, batches[s])
            float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    by_group = defaultdict(float)
    launches = defaultdict(int)
    by_kernel = []
    from repro_torch.models.moe import PHASES
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key in PHASES:      # a range's device span: no kernel
            continue
        by_group[group_of(ev.key)] += dev_us / 1e3 / STEPS
        launches[group_of(ev.key)] += ev.count // STEPS
        by_kernel.append((dev_us / 1e3 / STEPS, ev.count // STEPS,
                          ev.key))
    busy_ms = sum(by_group.values())
    tokens = dcfg.global_batch * dcfg.seq_len
    print(f"{cfg.name} x{cfg.n_layers} layers, mesh {mesh} (tp={tp}), batch "
          f"{dcfg.global_batch}x{dcfg.seq_len}, {backend}/"
          f"{wire_dtype} on {torch.cuda.get_device_name(0)}")
    print(f"step wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    for g, ms in sorted(by_group.items(), key=lambda t: -t[1]):
        print(f"  {g:26s} {ms:9.3f} ms  {ms / wall_ms:6.1%} of the step, "
              f"x{launches[g]} launches")
    print("top kernels (ms per step, launches per step):")
    for ms, n, name in sorted(by_kernel, reverse=True)[:TOP]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    moe = {k: v / STEPS for k, v in moe_split(prof.events()).items()}
    if moe:
        print("MoE layer by phase (device ms per step):")
        for k, v in sorted(moe.items(), key=lambda t: -t[1]):
            print(f"  {k:22s} {v:9.3f} ms  {v / wall_ms:6.1%} of the step")
    rec = {"backend": backend, "wire_dtype": wire_dtype, "mesh": mesh,
           "arch": cfg.name, "moe_phases_ms": moe,
           "wall_ms": wall_ms,
           "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
           "groups_ms": dict(by_group), "group_launches": dict(launches),
           "tokens_per_s": tokens / wall_ms * 1e3}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="pallas_fused",
                    choices=["bine", "pallas_fused"])
    ap.add_argument("--wire-dtype", nargs="+", default=["float32", "int8"],
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--mesh", default="4,1",
                    help="data,model or pod,data,model (the train CLI's)")
    ap.add_argument("--arch", default=cell.ARCH,
                    help="the train cell of this arch")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    moe = cell.MOE_TRAIN_CELL
    cfg = moe.model_config() if args.arch == moe.arch else \
        cell.model_config(args.arch)
    for wire_dtype in args.wire_dtype:
        profile(cfg, args.backend, wire_dtype, dev, args.mesh)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
