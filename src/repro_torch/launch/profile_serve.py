"""Where the time of serving goes on the card.

Builds the serve cell of ``launch/cell.py`` (the one ``chip_smoke.py``
serves: phi4-mini at full depth, an 8-page pool of 1024 tokens), fills
every page with one of the cell's requests, then profiles with
``torch.profiler`` one ``insert`` (a padded 1024-token prefill into a
page) and ``STEPS`` ``decode_slots`` steps with every page active, and
prints for each the wall time, the device time by kernel group and the
device's idle share, as text and as one JSON line:

  python -m repro_torch.launch.profile_serve
  python -m repro_torch.launch.profile_serve --mesh 2,2   # dp 2 x tp 2
  python -m repro_torch.launch.profile_serve --arch gemma3-4b

``--mesh data,model`` serves the cell over that many DP and TP ranks
stacked on the card (``launch/cell.py`` ``SERVE_TP_SHAPE``); ``--arch``
profiles that arch's serve cell (``cell.SERVE_CELLS``: phi4-mini,
gemma3-4b, gemma-7b, qwen3-32b, zamba2-2.7b, xlstm-125m, pixtral-12b,
musicgen-medium, mixtral-8x7b) in place of ``SERVE_CELL``.  The
recurrent, frontend and MoE configs, which the pool refuses, are
profiled as ``launch.serve.run_fixed_batch`` serves them
(:func:`profile_fixed`): one prefill of the cell's batch (frames for a
frontend) and ``STEPS`` decode steps; for mixtral-8x7b (``MOE_SERVE_CELL``:
8 of its 32 layers) also the device time under each MoE phase's range.
Their ``--mesh 1,n`` serves the loop over n TP ranks; a split recurrent
block's cross-rank norms (``models.ssm.SPLIT_NORM``) are then read as a
range too:

  python -m repro_torch.launch.profile_serve --arch zamba2-2.7b
  python -m repro_torch.launch.profile_serve --arch zamba2-2.7b --mesh 1,2
  python -m repro_torch.launch.profile_serve --arch pixtral-12b
  python -m repro_torch.launch.profile_serve --arch mixtral-8x7b
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch import cell
from repro_torch.launch.serve import fixed_batch_steps
from repro_torch.launch.profile_step import TOP, group_of
from repro_torch.launch.train import parse_mesh
from repro_torch.models import transformer as TF
from repro_torch.models.moe import PHASES
from repro_torch.models.ssm import SPLIT_NORM
from repro_torch.serve.engine import (ServeConfig, make_serve_fns, page_len,
                                      pool_supported)
from repro_torch.serve.sampling import gather_vocab
from repro_torch.serve.scheduler import poisson_trace

#: profiled decode steps
STEPS = 5


#: the ranges read by device time: each MoE phase's, the cross-rank norms'
RANGES = PHASES + (SPLIT_NORM,)


def _profile(fn, reps: int):
    """Wall ms per call, device ms per call by group, top kernels, and
    the device ms per call under each range of ``RANGES`` (the MoE
    phases, ``models.moe.PHASES``: routing, dispatch, experts, combine;
    the cross-rank norms), which the groups hold already and which a
    range's own device span would count twice."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_group = defaultdict(float)
    by_kernel, phases = [], {}
    for ev in prof.key_averages():
        if ev.key in RANGES:
            if ev.device_type == torch.autograd.DeviceType.CPU:
                phases[ev.key] = ev.device_time_total / 1e3 / reps
            continue
        dev_us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_group[group_of(ev.key)] += dev_us / 1e3 / reps
        by_kernel.append((dev_us / 1e3 / reps, ev.count // reps, ev.key))
    return (wall_ms, dict(by_group), sorted(by_kernel, reverse=True)[:TOP],
            phases)


def profile(cfg, params, dev, mesh: str = "1,1",
            c: cell.ServeCell = cell.SERVE_CELL) -> dict:
    """Profile one insert and ``STEPS`` decode steps of the serve cell
    ``c`` at ``mesh`` (``data,model``) on the card; prints the breakdown
    and returns ``{"insert": ..., "decode_step": ...}``, each with its
    wall and busy ms, idle share and device ms by group."""
    _, dp, tp = parse_mesh(mesh)
    S = page_len(cfg, c.prompt_len_max, c.max_new)
    fns = make_serve_fns(cfg, ServeConfig(), c.slots, S, dev, dp=dp, tp=tp)
    pool = fns.init_pool()
    reqs = poisson_trace(c.slots, c.rate, (c.prompt_len_min,
                                           c.prompt_len_max), c.max_new,
                         cfg.vocab_size, seed=c.seed)
    padded = np.zeros((c.slots, 1, S), np.int32)
    for i, r in enumerate(reqs):
        padded[i, 0, :len(r.prompt)] = r.prompt
        _, pool = fns.insert(params, pool, padded[i], len(r.prompt), i)
    tokens = np.zeros((c.slots, 1), np.int32)
    active = np.ones((c.slots,), np.int32)
    state = {"pool": pool}

    def insert():
        _, state["pool"] = fns.insert(params, fns.evict(state["pool"], 0),
                                      padded[0], len(reqs[0].prompt), 0)

    def decode():
        logits, state["pool"] = fns.decode_slots(params, state["pool"],
                                                 tokens, active)
        tokens[:, 0] = torch.argmax(gather_vocab(logits, cfg.vocab_size),
                                    -1).cpu().numpy()

    insert()
    decode()                                                 # warm-up
    out = {}
    print(f"{cfg.name} x{cfg.n_layers} layers, {c.slots} pages x {S} "
          f"tokens, mesh {mesh}, on {torch.cuda.get_device_name(0)}")
    for name, fn, reps in (("insert", insert, 2),
                           ("decode_step", decode, STEPS)):
        out[name] = _report(name, fn, reps)
    return out


def _report(name, fn, reps: int) -> dict:
    wall_ms, groups, top, phases = _profile(fn, reps)
    busy = sum(groups.values())
    print(f"{name}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall_ms:.3f}")
    for g, ms in sorted(groups.items(), key=lambda t: -t[1]):
        print(f"  {g:26s} {ms:9.3f} ms  {ms / wall_ms:6.1%}")
    print("  top kernels (ms per call, launches per call):")
    for ms, n, kname in top:
        print(f"    {ms:9.3f} ms  x{n:<5d} {kname[:90]}")
    rec = {"wall_ms": wall_ms, "busy_ms": busy,
           "idle_share": 1 - busy / wall_ms, "groups_ms": groups}
    moe = {k: v for k, v in phases.items() if k in PHASES}
    if moe:
        print("  MoE layers by phase (device ms per call, in the groups "
              "above):")
        for k, ms in sorted(moe.items(), key=lambda t: -t[1]):
            print(f"    {k:16s} {ms:9.3f} ms  {ms / wall_ms:6.1%}")
        rec["moe_phases_ms"] = moe
    if SPLIT_NORM in phases:
        ms = phases[SPLIT_NORM]
        print(f"  cross-rank norms ({SPLIT_NORM}): {ms:9.3f} ms, "
              f"{ms / busy:6.1%} of the device's busy time")
        rec["split_norm_ms"] = ms
    return rec


def profile_fixed(cfg, params, dev, c: cell.ServeCell, tp: int = 1) -> dict:
    """The fixed-batch loop of the serve cell ``c`` (a recurrent, frontend
    or MoE config; a MoE config's breakdown adds its layers' phases) over
    ``tp`` TP ranks: one prefill of ``c.slots`` prompts of
    ``c.prompt_len_max`` tokens and ``STEPS`` greedy decode steps from it
    (``launch.serve``'s ``fixed_batch_steps``), under torch.profiler;
    prints the breakdown and returns ``{"prefill": ..., "decode_step":
    ...}``."""
    prefill, decode = fixed_batch_steps(cfg, params, c.slots,
                                        c.prompt_len_max, c.seed, dev, tp)
    with torch.no_grad():
        prefill()
        decode()                                              # warm-up
        print(f"{cfg.name} x{cfg.n_layers} layers, fixed batch {c.slots} x "
              f"{c.prompt_len_max} tokens, {tp} TP rank(s), on "
              f"{torch.cuda.get_device_name(0)}")
        out = {"prefill": _report("prefill", prefill, 1)}
        prefill()
        out["decode_step"] = _report("decode_step", decode, STEPS)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,1",
                    help="data,model or pod,data,model")
    ap.add_argument("--arch", default=cell.SERVE_CELL.arch,
                    choices=sorted(cell.SERVE_CELLS))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = cell.SERVE_CELLS[args.arch]
    cfg = cell.serve_model_config(c)
    params = TF.init_params(cfg, c.seed, dev)
    if not pool_supported(cfg):
        _, dp, tp = parse_mesh(args.mesh)
        if int(np.prod(dp)) != 1:
            raise ValueError(f"the fixed-batch loop runs one DP rank, got "
                             f"--mesh {args.mesh}")
        print(json.dumps(profile_fixed(cfg, params, dev, c, tp)))
        return
    print(json.dumps(profile(cfg, params, dev, args.mesh, c)))


if __name__ == "__main__":
    main()
