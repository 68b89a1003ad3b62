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
phase, forward, recompute (``cfg.remat``: each layer's forward run again
in the backward) and backward (:func:`moe_split`: routing, dispatch, the
all_to_all, the experts, the combine):

  python -m repro_torch.launch.profile_step [--wire-dtype float32 int8] \
      [--mesh 2,2] [--arch mixtral-8x7b]
  python -m repro_torch.launch.profile_step --arch xlstm-125m \
      --wire-dtype float32

The recurrent cells over TP ranks (``cell.SSM_TP_TRAIN_CELLS``: a
``--mesh`` one of them lists picks that cell, xlstm-125m's cut to 4
blocks):

  python -m repro_torch.launch.profile_step --arch zamba2-2.7b --mesh 2,2 \
      --wire-dtype float32
  python -m repro_torch.launch.profile_step --arch xlstm-125m --mesh 2,2 \
      --wire-dtype float32

``--remat-depths 2,4`` measures in place of the profile what remat
(``cfg.remat``) saves: the cell's model at each depth with remat off and
on, the step's resident and peak GiB, its ms and the bytes saved for one
DP rank's backward, and the peak's slope per layer both ways
(:func:`remat_memory`):

  python -m repro_torch.launch.profile_step --wire-dtype float32 \
      --remat-depths 2,4,6

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
import math
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
                ev.name() == TF.RECOMPUTE or ev.is_user_annotation():
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
                or ev.key in PHASES + (TF.RECOMPUTE,):  # a range's span
            continue
        by_group[group_of(ev.key)] += dev_us / 1e3 / steps
        launches[group_of(ev.key)] += ev.count // steps
        counts[group_of(ev.key)] += ev.count
    return {"busy_ms": sum(by_group.values()), "groups_ms": dict(by_group),
            "group_launches": dict(launches), "group_counts": dict(counts)}


def _recomputed(ev) -> bool:
    """Does ``ev`` run inside a layer's recompute under remat (the
    ``models.transformer.RECOMPUTE`` range, which the backward opens)?"""
    while ev is not None:
        if ev.name == TF.RECOMPUTE:
            return True
        ev = ev.cpu_parent
    return False


def moe_split(events, attr: str = "device_time_total") -> dict:
    """The MoE layers' time by phase (``models.moe.PHASES``), ms summed
    over ``events`` (``prof.events()``), as ``"<phase> fwd"``,
    ``"<phase> recompute"`` and ``"<phase> bwd"``: a phase's forward is
    its range's time (the kernels of every op under it); under remat the
    same range run again inside the backward's ``RECOMPUTE`` range is its
    recompute, kept apart; a backward op (``autograd::engine::
    evaluate_function: ...``) counts to the phase whose range ran its
    forward op, matched by the autograd sequence number.  ``attr`` is the
    event's time to read (device time; ``cpu_time_total`` on the CPU)."""
    from repro_torch.models.moe import PHASES
    cpu = torch.autograd.DeviceType.CPU
    seq_phase, out = {}, defaultdict(float)
    for ev in events:
        if ev.name not in PHASES or ev.device_type != cpu:
            continue
        if _recomputed(ev):
            out[f"{ev.name} recompute"] += getattr(ev, attr) / 1e3
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


def saved_for_backward(cfg, params, batch, tp: int = 1) -> int:
    """The bytes autograd saves for the backward of ``loss_fn`` on one DP
    rank (``params``: its tree, ``batch``: its shard, as the train step's
    ``_rank_grads`` runs it), each storage counted once, read by a
    ``saved_tensors_hooks`` pack hook through the forward.  Under
    ``cfg.remat`` a checkpointed layer's saves go to the checkpoint's own
    hooks and are recomputed, so they are not counted; the layer inputs
    the checkpoint holds (one residual stream a layer) are not either."""
    from repro_torch import tree as T
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        # the storage stays alive with the graph (so no other tensor takes
        # its address), but the packed tensor carries no grad_fn: packing
        # an op's output itself would tie it to its node in a cycle that
        # no collector sees, and its bytes would outlive the graph
        return t.detach()

    leaves = [x.detach().requires_grad_(True) for x in T.flatten(params)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = TF.loss_fn(T.unflatten(params, leaves), cfg, batch,
                             n_model=tp)
    del loss
    return sum(seen.values())


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


def remat_memory(cfg, backend: str, wire_dtype: str, dev, mesh: str,
                 depths) -> list:
    """The memory remat saves, by depth: for each depth of ``depths`` the
    train cell's model cut to it, with ``cfg.remat`` off and on, one
    warm-up step and one measured step over the ranks of ``mesh``: the
    resident GiB before the step (params, optimizer state), the step's
    peak GiB and its ms, and the bytes saved for one DP rank's backward
    (:func:`saved_for_backward`).  Prints each row, then each setting's
    slope of the peak per layer between the first and the last depth, and
    returns the rows."""
    from repro_torch.launch.train import parse_mesh
    from repro_torch.models import sharding as SH
    axes, dp, tp = parse_mesh(mesh)
    tcfg = cell.train_config(backend, wire_dtype).replace(dp_axes=axes)
    n_dp = dp if isinstance(dp, int) else math.prod(dp)
    rows = []
    for depth in depths:
        for remat in (False, True):
            c = cfg.replace(n_layers=depth, remat=remat)
            dcfg = cell.data_config(c)
            params = TF.init_params(c, 0, dev)
            if tp > 1:
                params = SH.shard_params(c, params, tp)
            batch = {k: torch.as_tensor(v[:dcfg.global_batch // n_dp],
                                        device=dev)
                     for k, v in make_batch(dcfg, 0).items()}
            saved = saved_for_backward(c, params, batch, tp)
            del params, batch
            gc.collect()
            torch.cuda.empty_cache()
            step, _, _ = make_train_step(c, tcfg, dp, TF.param_shapes(c),
                                         dev, tp=tp)
            init_p, init_s = make_init_fns(c, tcfg, dp, dev, tp=tp)
            params = init_p(0)
            state = init_s(params)
            params, state, m = step(params, state, make_batch(dcfg, 0))
            float(m["loss"])
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, state, m = step(params, state, make_batch(dcfg, 1))
            loss = float(m["loss"])
            torch.cuda.synchronize()
            row = {"n_layers": depth, "remat": remat,
                   "step_ms": (time.perf_counter() - t0) * 1e3,
                   "resident_gib": resident,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "saved_for_backward_gb": saved / 1e9, "loss": loss}
            rows.append(row)
            print(f"{c.name} x{depth} mesh {mesh} remat "
                  f"{'on ' if remat else 'off'}: step {row['step_ms']:.1f} "
                  f"ms, resident {resident:.2f} GiB, peak "
                  f"{row['peak_gib']:.2f} GiB, saved for backward (one DP "
                  f"rank) {saved / 1e9:.3f} GB, loss {loss:.6f}",
                  flush=True)
            del step, params, state, m
            gc.collect()
            torch.cuda.empty_cache()
    lo, hi = min(depths), max(depths)
    if hi > lo:
        for remat in (False, True):
            pk = {r["n_layers"]: r["peak_gib"] for r in rows
                  if r["remat"] == remat}
            print(f"remat {'on ' if remat else 'off'}: peak slope "
                  f"{(pk[hi] - pk[lo]) / (hi - lo):.3f} GiB a layer "
                  f"({lo} -> {hi} layers)")
    print(json.dumps({"arch": cfg.name, "mesh": mesh, "remat_memory": rows}),
          flush=True)
    return rows


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
    ap.add_argument("--remat-depths", default="",
                    help="e.g. 2,4: in place of the profile, the step's "
                         "memory with remat off and on at each depth")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = tuple(int(v) for v in args.mesh.split(","))
    c = next((t for t in cell.SSM_TP_TRAIN_CELLS
              if t.arch == args.arch and mesh in t.meshes),
             cell.TRAIN_CELLS.get(args.arch))
    cfg = c.model_config() if c else cell.model_config(args.arch)
    if args.remat_depths:
        remat_memory(cfg, args.backend, args.wire_dtype[0], dev, args.mesh,
                     [int(d) for d in args.remat_depths.split(",")])
        return
    for wire_dtype in args.wire_dtype:
        profile(cfg, args.backend, wire_dtype, dev, args.mesh,
                compare=args.compare_accounting)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
