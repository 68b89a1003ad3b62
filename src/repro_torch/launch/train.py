"""End-to-end training driver of the PyTorch port.

Port of ``repro.launch.train``: synthetic data through the ``Prefetcher``,
the Bine gradient collectives, ZeRO-1 AdamW, async checkpointing and the
straggler monitor.  The DP ranks run stacked on one device
(``train.step``):

  python -m repro_torch.launch.train --arch phi4-mini-3.8b --reduced \\
      --mesh 4,1 --steps 20 --batch 8 --seq 64 --backend pallas_fused

``--mesh pod,data,model`` stacks two DP axes, as the reference's mesh has
them (``--mesh 2,2,1 --backend bine_hier`` runs the two-tier hierarchy);
a model axis above 1 (``--mesh 2,2``: data 2, model 2) stacks each DP
rank's TP ranks too, under the strategy ``models.sharding.strategy``
picks: ``megatron_sp`` where the heads divide over the model axis and
d_model >= 1024, else ``pure_sp``.  The MoE configs (``--arch
mixtral-8x7b``, ``phi3.5-moe-42b-a6.6b``) put their experts on the model
axis (``models.moe``: the dispatch and combine on the collectives API's
all_to_all) and log the weighted aux loss (at full depth, 46.7 B params,
mixtral does not fit one card):

  python -m repro_torch.launch.train --arch mixtral-8x7b --reduced --mesh 2,2

The frontend configs (``--arch musicgen-medium``, ``pixtral-12b``) train
on float frames of their ``frontend_dim`` (``train.data.make_batch``)
through the trainable ``frontend_proj``:

  python -m repro_torch.launch.train --arch musicgen-medium --reduced --mesh 2,2

The recurrent configs (``--arch zamba2-2.7b``, ``xlstm-125m``) take a
model axis too: under megatron_sp (zamba2 at full width) each TP rank
runs its share of Mamba2's heads, mLSTM's heads or sLSTM's units; under
pure_sp (xlstm-125m) every rank runs each recurrent block on the whole
sequence:

  python -m repro_torch.launch.train --arch zamba2-2.7b --reduced --mesh 2,2 \
      --device cpu --steps 2 --batch 8 --seq 64

``--ckpt-dir D --ckpt-every N`` saves the global train state every N steps
and after the last, in the reference's format; ``--resume`` continues from
the latest step in ``D`` (a checkpoint of either package, at any DP size).
Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import base as cfgbase
from repro_torch.models import transformer as TF
from repro_torch.models.sharding import strategy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, Prefetcher
from repro_torch.train.runtime import StragglerMonitor
from repro_torch.train.step import (TrainConfig, from_global, make_init_fns,
                                    make_train_step, to_global)


def parse_mesh(mesh: str) -> Tuple[Tuple[str, ...], Tuple[int, ...], int]:
    """``pod,data,model`` or ``data,model`` -> (dp_axes, their sizes, the
    model axis's size), as the reference names a mesh's axes."""
    shape = tuple(int(x) for x in mesh.split(","))
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"mesh {mesh!r}: expected pod,data,model or "
                         "data,model")
    axes = ("pod", "data", "model")[-len(shape):]
    return axes[:-1], shape[:-1], shape[-1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--mesh", default="4,1",
                    help="pod,data,model or data,model")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--backend", default="bine",
                    choices=["bine", "recdoub", "ring", "xla", "bine_hier",
                             "pallas_fused", "auto"])
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
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfgbase.get_config(args.arch)
    if args.reduced:
        cfg = cfgbase.reduced(cfg)
    dp_axes, dp, tp = parse_mesh(args.mesh)

    acfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                       total_steps=args.steps)
    tcfg = TrainConfig(backend=args.backend, dp_axes=dp_axes,
                       accum_steps=args.accum, adamw=acfg,
                       wire_dtype=args.wire_dtype, topology=args.topology)
    shapes = TF.param_shapes(cfg)
    print(f"[train] arch={cfg.name} params={TF.param_count(shapes):,} "
          f"dp={dict(zip(dp_axes, dp))} tp={tp} ({strategy(cfg, tp)}) "
          f"backend={args.backend} wire={args.wire_dtype} "
          f"topology={args.topology} device={dev}")
    step_fn, info, _ = make_train_step(cfg, tcfg, dp, shapes, dev, tp=tp)
    init_p, init_s = make_init_fns(cfg, tcfg, dp, dev, tp=tp)
    params = init_p(args.seed)
    state = init_s(params)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      vocab_size=cfg.vocab_size, seed=args.seed + 1,
                      frontend_dim=cfg.frontend_dim if cfg.frontend else 0)

    def global_state():
        return to_global(cfg, tcfg, params, state, dp, tp=tp)

    cpr = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    monitor = StragglerMonitor()
    start = 0
    if args.resume and args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            like = to_global(cfg, tcfg, params, state, dp, device="meta",
                             tp=tp)
            tree = ckpt.restore(args.ckpt_dir, latest, like, device="cpu")
            params, state = from_global(cfg, tcfg, tree, dp, dev, tp=tp)
            del tree
            start = latest
            print(f"[train] resumed from step {start}")

    pf = Prefetcher(dcfg, start_step=start)
    try:
        t_all = time.time()
        for s in range(start, args.steps):
            t0 = time.time()
            _, b = pf.next()
            params, state, metrics = step_fn(params, state, b)
            loss = float(metrics["loss"])     # waits for the device
            dt = time.time() - t0
            if monitor.observe(s, dt):
                print(f"[straggler] step {s} took {dt:.3f}s "
                      f"(ewma {monitor.ewma:.3f}s)")
            if s % args.log_every == 0 or s == args.steps - 1:
                aux = (f"aux {float(metrics['aux_loss']):.4f} "
                       if cfg.n_experts else "")
                print(f"step {s:5d} loss {loss:.4f} {aux}"
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms")
            if cpr and (s + 1) % args.ckpt_every == 0:
                cpr.save(s + 1, global_state())
        if cpr:
            cpr.save(args.steps, global_state(), block=True)
        total = time.time() - t_all
        print(f"[train] done: {args.steps - start} steps in {total:.1f}s "
              f"({(args.steps - start) / max(total, 1e-9):.2f} it/s); "
              f"stragglers flagged: {len(monitor.flagged)}")
    finally:
        pf.close()


if __name__ == "__main__":
    main()
