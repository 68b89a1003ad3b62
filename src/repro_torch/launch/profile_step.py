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
another arch's train cell (``cell.model_config(arch)``, or its cell of
``cell.TRAIN_CELLS``: mixtral-8x7b's ``MOE_TRAIN_CELL``, one layer;
zamba2-2.7b's and xlstm-125m's ``SSM_TRAIN_CELLS``, at their mesh
``4,1``); for a MoE arch it also splits the MoE layer's device time by
phase, forward and backward (:func:`moe_split`: routing, dispatch, the
all_to_all, the experts, the combine):

  python -m repro_torch.launch.profile_step [--wire-dtype float32 int8] \
      [--mesh 2,2] [--arch mixtral-8x7b]
  python -m repro_torch.launch.profile_step --arch xlstm-125m \
      --wire-dtype float32

The device time is read from the profiler's raw kineto events
(:func:`device_events`); ``--compare-accounting`` also reads the same
profile through ``key_averages`` (:func:`key_average_groups`, the
accounting of earlier readings) and prints both.

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


def device_events(prof):
    """(name, device ms) of every kernel, copy and set the profiler ``prof``
    saw on the card, read from its raw kineto events (no event tree is
    built: an xlstm step's million launches would take minutes), a
    ``record_function`` range's device span left out (a torch without
    ``is_user_annotation`` raises rather than count such spans as busy)."""
    from repro_torch.models.moe import PHASES
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda or ev.name() in PHASES or \
                ev.is_user_annotation():
            continue
        yield ev.name(), ev.duration_ns() / 1e6


def key_average_groups(prof, steps: int) -> dict:
    """The accounting ``device_events`` replaced, for comparing the two on
    one profile: each kernel's ``self_device_time_total`` of
    ``prof.key_averages()`` (which builds the event tree) by group, ms a
    step, its launches floored a kernel (``group_launches``, as earlier
    readings floored them) and unfloored over the ``steps`` profiled
    steps (``group_counts``, which the raw events' own must equal: where
    a kernel's launches differ between steps, flooring a kernel and
    flooring a group give different counts)."""
    from repro_torch.models.moe import PHASES
    by_group = defaultdict(float)
    launches, counts = defaultdict(int), defaultdict(int)
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key in PHASES:      # a range's device span: no kernel
            continue
        by_group[group_of(ev.key)] += dev_us / 1e3 / steps
        launches[group_of(ev.key)] += ev.count // steps
        counts[group_of(ev.key)] += ev.count
    return {"busy_ms": sum(by_group.values()), "groups_ms": dict(by_group),
            "group_launches": dict(launches), "group_counts": dict(counts)}


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


def profile(cfg, backend: str, wire_dtype: str, dev, mesh: str = "4,1",
            steps: int = STEPS, compare: bool = False) -> dict:
    """Warm up, then profile ``steps`` steps of one wire dtype over the
    ranks of ``mesh`` (``launch.train.parse_mesh``); prints the breakdown
    and returns its JSON record (with ``compare``, also the same profile
    read by ``key_average_groups``, under ``"key_averages"``)."""
    from repro_torch.launch.train import parse_mesh
    axes, dp, tp = parse_mesh(mesh)
    tcfg = cell.train_config(backend, wire_dtype).replace(dp_axes=axes)
    step, _, _ = make_train_step(cfg, tcfg, dp, TF.param_shapes(cfg), dev,
                                 tp=tp)
    init_p, init_s = make_init_fns(cfg, tcfg, dp, dev, tp=tp)
    params = init_p(0)
    state = init_s(params)
    dcfg = cell.data_config(cfg)
    batches = [make_batch(dcfg, s) for s in range(steps + 1)]

    params, state, m = step(params, state, batches[0])     # warm-up
    float(m["loss"])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(1, steps + 1):
            params, state, m = step(params, state, batches[s])
            float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    by_group = defaultdict(float)
    launches = defaultdict(int)
    kernels = defaultdict(lambda: [0.0, 0])
    for name, ms in device_events(prof):
        by_group[group_of(name)] += ms / steps
        launches[group_of(name)] += 1
        kernels[name][0] += ms / steps
        kernels[name][1] += 1
    counts = dict(launches)                # over the profiled steps
    launches = {g: n // steps for g, n in launches.items()}
    by_kernel = [(ms, n // steps, name) for name, (ms, n) in kernels.items()]
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
    moe = {k: v / steps for k, v in moe_split(prof.events()).items()} \
        if cfg.n_experts else {}
    if moe:
        print("MoE layer by phase (device ms per step):")
        for k, v in sorted(moe.items(), key=lambda t: -t[1]):
            print(f"  {k:22s} {v:9.3f} ms  {v / wall_ms:6.1%} of the step")
    rec = {"backend": backend, "wire_dtype": wire_dtype, "mesh": mesh,
           "arch": cfg.name, "moe_phases_ms": moe,
           "wall_ms": wall_ms,
           "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
           "groups_ms": dict(by_group), "group_launches": dict(launches),
           "group_counts": counts,
           "tokens_per_s": tokens / wall_ms * 1e3}
    if compare:
        old = rec["key_averages"] = key_average_groups(prof, steps)
        print(f"key_averages: device busy {old['busy_ms']:.1f} ms (raw "
              f"events {busy_ms:.1f})")
        for g, ms in sorted(by_group.items(), key=lambda t: -t[1]):
            print(f"  {g:26s} {old['groups_ms'].get(g, 0.0):9.3f} ms "
                  f"(raw events {ms:9.3f}), x"
                  f"{old['group_counts'].get(g, 0)} (x{counts[g]}) over "
                  f"{steps} steps")
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
    ap.add_argument("--compare-accounting", action="store_true",
                    help="also read the profile by key_averages")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = cell.TRAIN_CELLS.get(args.arch)
    cfg = c.model_config() if c else cell.model_config(args.arch)
    for wire_dtype in args.wire_dtype:
        profile(cfg, args.backend, wire_dtype, dev, args.mesh,
                compare=args.compare_accounting)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
