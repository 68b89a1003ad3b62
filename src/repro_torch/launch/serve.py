"""Serving CLI of the PyTorch port: a Poisson arrival trace of
mixed-length requests through the paged-KV scheduler, or for the
architectures the pool cannot serve the reference's fixed-batch loop.

Port of ``repro.launch.serve``.  Its defaults are the serve cell of
``launch/cell.py`` (phi4-mini at full depth, 8 pages, 16 requests);
``--arch`` serves any registered config:

  python -m repro_torch.launch.serve                       # on the card
  python -m repro_torch.launch.serve --arch gemma3-4b --prompt-len-min 1088 \
      --prompt-len-max 1984 --slots 4 --requests 8         # past its window
  python -m repro_torch.launch.serve --arch zamba2-2.7b --slots 4 \
      --prompt-len-max 1024                                # fixed batch
  python -m repro_torch.launch.serve --reduced --device cpu
  python -m repro_torch.launch.serve --arch gemma3-4b --reduced --device cpu
  python -m repro_torch.launch.serve --arch xlstm-125m --reduced --device cpu
  python -m repro_torch.launch.serve --reduced --device cpu --mesh 2,2

Each request prefills into a free KV page, decodes interleaved with
whatever else is running, and retires on EOS or its token budget,
recycling the page.  ``--mesh data,model`` (or ``pod,data,model``) serves
over that many DP and TP ranks, stacked on the one device
(``serve.engine``); ``--backend auto`` prints the collective plan the
decision table picks for it, as the reference's CLI does, ``--backend
xla`` pins the defaults (no plan).  In place of the reference's
``traces:`` line (jit retraces) it prints the kernel launch counts of the
run.  Runs on CUDA unless ``--device cpu`` is given.

The architectures the pool cannot serve (``serve.engine.pool_supported``:
recurrent blocks, MoE capacity dispatch, modality frontends) go, as in
the reference, to :func:`run_fixed_batch`: one lock-step batch of
``--slots`` prompts of ``--prompt-len-max`` tokens (a frontend model's
prompt and each decode step's input random float frames), greedily
decoded for ``--max-new`` tokens.  It serves the recurrent configs
(xlstm-125m, zamba2-2.7b), the frontend ones (musicgen-medium,
pixtral-12b) and the MoE ones (mixtral-8x7b, phi3.5-moe-42b-a6.6b: the
capacity dispatch over each call's tokens, so a decode step's B tokens
compete for an expert's slots), on one rank or over ``--mesh 1,n`` TP
ranks (``transformer.prefill_tp`` / ``decode_step_tp``: a MoE prefill
takes expert parallelism where the sequence and the expert blocks divide
n, as the reference's does under its mesh):

  python -m repro_torch.launch.serve --arch pixtral-12b --slots 4 \
      --prompt-len-max 1024                                # frames
  python -m repro_torch.launch.serve --arch musicgen-medium --reduced --device cpu
  python -m repro_torch.launch.serve --arch mixtral-8x7b --reduced --device cpu
  python -m repro_torch.launch.serve --arch zamba2-2.7b --reduced --device cpu \
      --mesh 1,2                                           # over 2 TP ranks
  python -m repro_torch.launch.serve --arch zamba2-2.7b --slots 4 \
      --prompt-len-max 1024 --mesh 1,2                     # on the card

The fixed-batch loop runs one DP rank: a data axis above 1 raises.
Full-depth mixtral (46.7 B) does not fit one card; its serve cell
(``launch/cell.py`` ``MOE_SERVE_CELL``) cuts it to 8 layers.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import base as cfgbase
from repro_torch.kernels import build as KB
from repro_torch.launch.cell import SERVE_CELL
from repro_torch.launch.train import parse_mesh
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as TF
from repro_torch.serve import kvcache as KV
from repro_torch.serve.engine import (ServeConfig, cache_layout,
                                      make_serve_fns, page_len,
                                      pool_supported)
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                         poisson_trace, wall_ttft_ms)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fixed_batch_steps(cfg, params, batch: int, prompt_len: int,
                      seed: int = 0, device="cuda", tp: int = 1):
    """The fixed-batch loop's two steps, as closures over one cache:
    ``prefill()`` runs ``prefill`` on ``batch`` prompts of ``prompt_len``
    tokens drawn from ``np.random.RandomState(seed)`` as the reference
    draws them (caches exactly ``prompt_len`` long, as the reference's
    are), ``decode()`` one ``decode_step`` at the shared scalar position;
    each returns its greedy tokens ``[batch, 1]``.  A frontend model's
    prompt is ``randn(batch, prompt_len, frontend_dim)`` float32 frames
    and each decode step's input fresh ``randn(batch, 1, frontend_dim)``
    frames from the same ``RandomState``, in the reference's order: the
    greedy tokens are returned, the frames feed the next step.  Over
    ``tp > 1`` stacked TP ranks they run ``prefill_tp`` and
    ``decode_step_tp``, the state laid out by ``engine.cache_layout``
    (the ranks' vocab blocks gathered before the argmax)."""
    dev = resolve_device(device)
    layout = cache_layout(cfg, batch, prompt_len, 1, tp) if tp > 1 \
        else None
    rng = np.random.RandomState(seed)

    def frames(length):
        return torch.as_tensor(rng.randn(batch, length, cfg.frontend_dim),
                               dtype=torch.float32, device=dev)

    if cfg.frontend:
        prompt = frames(prompt_len)
    else:
        prompt = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                             size=(batch, prompt_len)),
                                 dtype=torch.int32, device=dev)
    st = {}

    def prefill():
        if layout is None:
            logits, st["cache"] = TF.prefill(params, cfg, prompt)
        else:
            blocks, cache = TF.prefill_tp(params, cfg, prompt, tp)
            logits = TF.vocab_logits(blocks, cfg.vocab_size)
            st["cache"] = KV.state_from_global(cfg, cache, layout)
        st["tok"] = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return st["tok"]

    def decode():
        step_in = frames(1) if cfg.frontend else st["tok"]
        if layout is None:
            logits, st["cache"] = TF.decode_step(params, cfg, st["cache"],
                                                 step_in)
        else:
            blocks, st["cache"] = TF.decode_step_tp(params, cfg, st["cache"],
                                                    step_in, layout)
            logits = TF.vocab_logits(blocks, cfg.vocab_size)
        st["tok"] = torch.argmax(logits, dim=-1).to(torch.int32)
        return st["tok"]
    return prefill, decode


def run_fixed_batch(cfg, params, batch: int, prompt_len: int, max_new: int,
                    seed: int = 0, device="cuda", tp: int = 1):
    """The reference's legacy lock-step loop for the architectures the
    pool cannot serve: one prefill and ``max_new - 1`` greedy decode steps
    (``fixed_batch_steps``, over ``tp`` TP ranks).  Prints the
    reference's lines; returns the tokens ``[batch, max_new]`` (numpy) and
    the numbers: prefill and decode ms (synced, host clock), decode
    tokens/s."""
    dev = resolve_device(device)
    B, Lp = batch, prompt_len
    prefill, decode = fixed_batch_steps(cfg, params, B, Lp, seed, dev, tp)
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        outs = [prefill()]
        _sync(dev)
        pre_ms = (time.perf_counter() - t0) * 1e3
        print(f"[serve] fixed-batch prefill {B}x{Lp}: {pre_ms:.0f}ms")
        t0 = time.perf_counter()
        for _ in range(max_new - 1):
            outs.append(decode())
        _sync(dev)
        dt = time.perf_counter() - t0
    n = max_new - 1
    tps = B * max(n, 1) / max(dt, 1e-9)
    print(f"[serve] fixed-batch decode {n} steps: {dt * 1e3:.0f}ms "
          f"({tps:.1f} tok/s)")
    tokens = torch.cat(outs, dim=1).cpu().numpy()
    print("[serve] sample token ids:", tokens[0][:16].tolist())
    return tokens, {"prefill_ms": pre_ms, "decode_ms": dt * 1e3,
                    "decode_tokens_per_s": tps}


def main(argv=None):
    c = SERVE_CELL
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=c.arch)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--mesh", default="1,1",
                    help="data,model or pod,data,model")
    ap.add_argument("--slots", type=int, default=c.slots)
    ap.add_argument("--requests", type=int, default=c.requests)
    ap.add_argument("--rate", type=float, default=c.rate,
                    help="Poisson arrival rate (requests per decode step)")
    ap.add_argument("--prompt-len-min", type=int, default=c.prompt_len_min)
    ap.add_argument("--prompt-len-max", type=int, default=c.prompt_len_max)
    ap.add_argument("--max-new", type=int, default=c.max_new)
    ap.add_argument("--temperature", type=float, default=c.temperature)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="pool-global nucleus sampling threshold")
    ap.add_argument("--backend", default="auto", choices=("auto", "xla"))
    ap.add_argument("--seed", type=int, default=c.seed)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = cfgbase.get_config(args.arch)
    if args.reduced:
        cfg = cfgbase.reduced(cfg)

    _, dp, tp = parse_mesh(args.mesh)
    if not pool_supported(cfg):
        if int(np.prod(dp)) != 1:
            raise ValueError(f"the fixed-batch loop runs one DP rank, got "
                             f"--mesh {args.mesh}")
        params = TF.init_params(cfg, args.seed, dev)
        why = ("a modality frontend" if cfg.frontend else
               "MoE capacity dispatch" if cfg.n_experts else
               "recurrent blocks")
        print(f"[serve] {args.arch}: pool unsupported ({why}) — "
              f"legacy fixed-batch loop" +
              (f" over {tp} TP ranks ({SH.strategy(cfg, tp)})"
               if tp > 1 else ""))
        KB.reset_launches()
        run_fixed_batch(cfg, params, args.slots, args.prompt_len_max,
                        args.max_new, seed=args.seed, device=dev, tp=tp)
        print(f"[serve] kernel launches: "
              f"{ {k: v for k, v in KB.LAUNCHES.items() if v} }")
        return
    S = page_len(cfg, args.prompt_len_max, args.max_new)
    scfg = ServeConfig(backend=args.backend)
    fns = make_serve_fns(cfg, scfg, args.slots, S, dev, dp=dp, tp=tp)
    params = TF.init_params(cfg, args.seed, dev)
    if fns.plan:
        print(f"[serve] collective plan ({scfg.topology}):")
        for k, v in sorted(fns.plan.items()):
            print(f"[serve]   {k:24s} -> {v}")

    trace = poisson_trace(
        args.requests, args.rate, (args.prompt_len_min, args.prompt_len_max),
        args.max_new, cfg.vocab_size, seed=args.seed,
        temperature=args.temperature)
    sched = ContinuousBatchingScheduler(
        cfg, fns, params, args.slots, S, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed)
    for req in trace:
        sched.submit(req)
    _sync(dev)
    KB.reset_launches()
    t0 = time.perf_counter()
    stats = sched.run()
    _sync(dev)
    dt = time.perf_counter() - t0

    print(f"[serve] {cfg.name} ({cfg.n_layers} layers) on {dev}: "
          f"{args.requests} requests, {args.slots} pages x {S} tokens, "
          f"mesh {args.mesh}, backend={args.backend}")
    print(f"[serve] {stats['tokens_out']} tokens in {dt * 1e3:.0f}ms "
          f"({stats['tokens_out'] / max(dt, 1e-9):.1f} tok/s), "
          f"{stats['decode_steps']} decode steps, "
          f"occupancy mean {stats['mean_occupancy']:.2f} / "
          f"peak {stats['peak_occupancy']} of {args.slots}; ttft "
          f"{wall_ttft_ms(trace)}")
    print(f"[serve] kernel launches: "
          f"{ {k: v for k, v in KB.LAUNCHES.items() if v} }")
    done = [r for r in trace if r.finished]
    print(f"[serve] finished {len(done)}/{len(trace)}; sample request 0 ids:",
          trace[0].generated[:16])


if __name__ == "__main__":
    main()
