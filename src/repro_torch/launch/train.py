"""End-to-end training driver of the PyTorch port.

Port of ``repro.launch.train`` (checkpointing is not ported yet).  The DP
ranks run stacked on one device (``train.step``):

  python -m repro_torch.launch.train --arch phi4-mini-3.8b --reduced \\
      --mesh 4,1 --steps 20 --batch 8 --seq 64 --backend pallas_fused

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import base as cfgbase
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.train.step import TrainConfig, make_init_fns, make_train_step


def parse_mesh(mesh: str) -> int:
    """``1,<dp>,1`` or ``<dp>,1`` -> the DP rank count (model axis 1)."""
    shape = tuple(int(x) for x in mesh.split(","))
    if len(shape) == 3 and shape[0] == 1 and shape[2] == 1:
        return shape[1]
    if len(shape) == 2 and shape[1] == 1:
        return shape[0]
    raise NotImplementedError(
        f"mesh {mesh!r}: this port runs one DP axis with model axis 1 "
        "(1,<dp>,1 or <dp>,1); tensor parallelism is ROADMAP.md queue A "
        "item 3")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--mesh", default="4,1", help="1,<dp>,1 or <dp>,1")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--backend", default="bine",
                    choices=["bine", "recdoub", "ring", "xla", "pallas_fused",
                             "auto"])
    ap.add_argument("--topology", default="tpu_multipod",
                    help="decision-table preset for --backend auto, "
                         "--wire-dtype auto and the bucket size")
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8", "auto"],
                    help="gradient/param wire; int8 = pow2-scale codec with "
                         "error feedback (bucketed path), auto = per-bucket "
                         "(backend, wire) table lookup")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfgbase.get_config(args.arch)
    if args.reduced:
        cfg = cfgbase.reduced(cfg)
    n_dp = parse_mesh(args.mesh)

    acfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                       total_steps=args.steps)
    tcfg = TrainConfig(backend=args.backend, accum_steps=args.accum,
                       adamw=acfg, wire_dtype=args.wire_dtype,
                       topology=args.topology)
    shapes = TF.param_shapes(cfg)
    print(f"[train] arch={cfg.name} params={TF.param_count(shapes):,} "
          f"dp={n_dp} backend={args.backend} wire={args.wire_dtype} "
          f"topology={args.topology} device={dev}")
    step_fn, info, _ = make_train_step(cfg, tcfg, n_dp, shapes, dev)
    init_p, init_s = make_init_fns(cfg, tcfg, n_dp, dev)
    params = init_p(args.seed)
    state = init_s(params)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      vocab_size=cfg.vocab_size, seed=args.seed + 1)

    t_all = time.time()
    for s in range(args.steps):
        t0 = time.time()
        params, state, metrics = step_fn(params, state, make_batch(dcfg, s))
        loss = float(metrics["loss"])     # waits for the device
        dt = time.time() - t0
        if s % args.log_every == 0 or s == args.steps - 1:
            print(f"step {s:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms")
    total = time.time() - t_all
    print(f"[train] done: {args.steps} steps in {total:.1f}s "
          f"({args.steps / max(total, 1e-9):.2f} it/s)")


if __name__ == "__main__":
    main()
