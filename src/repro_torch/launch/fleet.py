"""Multi-replica serve fleet driver: placement, routing, elasticity.

Port of ``repro.launch.fleet``:

  # placement plans only (no device): score contiguous vs round-robin
  # on every packaged topology preset
  python -m repro_torch.launch.fleet --dryrun --ranks 8 --replicas 2 --tp 4

  # serve a Poisson trace over 3 replicas of one set of engine fns, with a
  # mid-trace drain + respawn, persisting measured tick latency
  python -m repro_torch.launch.fleet --arch gemma3-4b --reduced --mesh 2,2 \\
      --replicas 3 --slots 4 --requests 24 --rate 1.0 --max-new 16 \\
      --drain 6:1 --respawn 12:1 --device-kind cpu --save-feedback \\
      --device cpu

``--dryrun`` prints the :mod:`repro_torch.fleet.placement` plan — the
modeled allocation, both placement strategies scored by predicted
per-decode-step global-link bytes, and the argmin — for one preset or all
of them (grouped presets via ``tier_split_or_none``, the torus via its
dimension-contiguous fallback), in the reference's text.

The serve path wraps N ``ContinuousBatchingScheduler`` replicas around
one ``serve.engine.make_serve_fns`` and one copy of the weights (N KV
pools), each replica's ``--mesh data,model`` ranks stacked on the one
``--device`` (CUDA unless ``--device cpu``), routes the trace through the
session/prefix-affinity router, fires ``--drain``/``--respawn`` events
mid-trace, runs under the self-healing supervisor when
``--chaos-events`` or ``--chaos-seed`` give a fault schedule, and reports
fleet stats including per-request latency percentiles in virtual ticks.
Where the reference prints its jit trace counts it prints the run's
kernel launch counts.  ``--save-feedback`` persists the measured
per-replica EWMA tick latency to the ``(device_kind, topology, p)``
feedback store that warm-starts the next run's routing; ``--obs-out``
writes the reference's ``fleet_serve`` artifact, which
``launch/report.py`` renders.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
from typing import List

from repro_torch.fleet.placement import (decode_payloads, format_plan,
                                         plan_placement)
from repro_torch.topology.presets import PRESETS


def _events(args) -> List["FleetEvent"]:  # noqa: F821 — imported lazily
    from repro_torch.fleet import FleetEvent
    evs = []
    for action, specs in (("drain", args.drain), ("respawn", args.respawn)):
        for spec in specs:
            tick, _, rep = spec.partition(":")
            evs.append(FleetEvent(int(tick), action, int(rep)))
    return sorted(evs, key=lambda e: (e.tick, e.action, e.replica))


def _chaos_schedule(args):
    """The run's fault schedule: explicit ``--chaos-events`` specs win;
    ``--chaos-seed`` alone generates crash/straggler events over the
    trace.  Returns None when neither flag is given (plain fleet loop,
    no supervisor)."""
    from repro_torch.resilience import (ChaosSchedule, generate_events,
                                        parse_event)
    evs = [parse_event(s) for s in args.chaos_events]
    if not evs and args.chaos_seed is not None:
        evs = list(generate_events(args.chaos_seed,
                                   n_ticks=max(4, args.requests),
                                   n_replicas=args.replicas,
                                   n_events=args.chaos_n_events))
    if not evs:
        return None
    return ChaosSchedule(evs)


def _model_config(args):
    from repro_torch.configs import base as cfgbase
    cfg = cfgbase.get_config(args.arch)
    return cfgbase.reduced(cfg) if args.reduced else cfg


def run_dryrun(args) -> None:
    """Print the scored placement plan per preset — pure cost model, no
    device."""
    cfg = _model_config(args)
    payloads = decode_payloads(args.slots, cfg.n_heads, cfg.head_dim,
                               cfg.vocab_size)
    presets = PRESETS if args.topology == "all" else (args.topology,)
    for preset in presets:
        plan = plan_placement(preset, args.ranks, args.replicas, args.tp,
                              payloads)
        print(format_plan(plan))


def run_serve(args) -> dict:
    """Serve the trace over the fleet; returns the fleet's stats."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.fleet import Fleet, FleetConfig
    from repro_torch.kernels import build as KB
    from repro_torch.launch.train import parse_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import (ServeConfig, make_serve_fns,
                                          page_len, pool_supported)
    from repro_torch.serve.scheduler import poisson_trace

    cfg = _model_config(args)
    dev = resolve_device(args.device)
    _, dp, tp = parse_mesh(args.mesh)

    # the placement report for this fleet shape on the requested topology
    payloads = decode_payloads(args.slots, cfg.n_heads, cfg.head_dim,
                               cfg.vocab_size)
    plan = plan_placement(args.topology, args.replicas * tp, args.replicas,
                          tp, payloads)
    print(format_plan(plan))

    if not pool_supported(cfg):
        raise SystemExit(
            f"[fleet] {args.arch}: pool unsupported (see engine."
            f"pool_supported) — the fleet needs the paged-KV scheduler")
    S = page_len(cfg, args.prompt_len_max, args.max_new)
    scfg = ServeConfig(backend=args.backend, topology=args.topology)
    fns = make_serve_fns(cfg, scfg, args.slots, S, dev, dp=dp, tp=tp)
    params = TF.init_params(cfg, args.seed, dev)

    trace = poisson_trace(
        args.requests, args.rate, (args.prompt_len_min, args.prompt_len_max),
        args.max_new, cfg.vocab_size, seed=args.seed,
        temperature=args.temperature, n_sessions=args.sessions)
    events = _events(args)

    fcfg = FleetConfig(n_replicas=args.replicas, n_slots=args.slots,
                       topology=args.topology, seed=args.seed,
                       top_k=args.top_k, top_p=args.top_p,
                       device_kind=args.device_kind,
                       warm_start=not args.cold_start)
    chaos = _chaos_schedule(args)
    fleet = Fleet(cfg, fns, params, fcfg, S)
    fleet.submit_trace(trace)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    KB.reset_launches()
    t0 = time.perf_counter()
    if chaos is not None:
        from repro_torch.resilience import FleetSupervisor, SupervisorConfig
        sup = FleetSupervisor(fleet, chaos, SupervisorConfig(
            max_ticks=args.max_ticks, seed=args.seed))
        print(f"[fleet] chaos: {chaos.signature()}")
        stats = sup.run(events=events)
    else:
        stats = fleet.run(events=events, max_ticks=args.max_ticks)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    print(f"[fleet] {args.replicas} replicas x {args.slots} pages x {S} "
          f"tokens, {args.requests} requests @ rate {args.rate}, "
          f"backend={args.backend}")
    if events:
        print(f"[fleet] events: " + ", ".join(
            f"{e.action}@{e.tick}->r{e.replica}" for e in events))
    print(f"[fleet] {stats['tokens_out']} tokens in {dt*1e3:.0f}ms "
          f"({stats['tokens_out'] / max(dt, 1e-9):.1f} tok/s), "
          f"{stats['ticks']} fleet ticks, "
          f"{stats['decode_steps']} decode steps")
    lat = stats["latency"]
    print(f"[fleet] latency (virtual ticks): "
          f"ttft p50 {lat['ttft_p50']:.1f} / p99 {lat['ttft_p99']:.1f}, "
          f"e2e p50 {lat['e2e_p50']:.1f} / p99 {lat['e2e_p99']:.1f}")
    rt = stats["routing"]
    print(f"[fleet] routing: {rt['n_routed']} routed "
          f"({rt['n_spilled']} spilled), per replica {rt['per_replica']}")
    for rid, rs in stats["replicas"].items():
        print(f"[fleet]   replica {rid}: {rs['state']}, "
              f"{rs['tokens_out']} tokens / {rs['decode_steps']} steps, "
              f"{rs['respawns']} respawns, "
              f"ewma tick {rs['ewma_tick_s']*1e3:.2f}ms")
    res = stats.get("resilience")
    if res is not None:
        mttr = res["mttr_ticks"]
        print(f"[fleet] resilience: {len(res['crashes'])} crashes, "
              f"mttr {'n/a' if mttr is None else f'{mttr:.1f} ticks'}, "
              f"{len(res['shed'])} shed / {res['requeued']} requeued")
        for c in res["crashes"]:
            print(f"[fleet]   crash r{c['replica']}@{c['crash_tick']}: "
                  f"{c['displaced']} displaced, respawned @"
                  f"{c['respawn_tick']} (ttr {c['ttr']})")
    print(f"[fleet] kernel launches: "
          f"{ {k: v for k, v in KB.LAUNCHES.items() if v} }")
    done = sum(r.finished for r in trace)
    print(f"[fleet] finished {done}/{len(trace)}; sample request 0 ids:",
          trace[0].generated[:16])

    if args.save_feedback:
        path = fleet.save_feedback(timestamp=args.timestamp)
        print(f"[fleet] feedback saved: {path}")

    if args.obs_out:
        import json

        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs import timeline as obs_timeline
        tl = obs_timeline.get_timeline()
        artifact = {
            "format": 1,
            "timestamp": args.timestamp,
            "kind": "fleet_serve",
            "config": {"arch": args.arch, "topology": args.topology,
                       "backend": args.backend, "replicas": args.replicas,
                       "slots": args.slots, "requests": args.requests},
            "registry": obs_metrics.get_registry().snapshot(),
            "timeline": tl.to_json_dict(),
            "chrome_trace": obs_timeline.to_chrome_trace(tl),
            "stats": stats,
        }
        with open(args.obs_out, "w") as f:
            json.dump(artifact, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
        print(f"[fleet] obs artifact ({len(tl)} timeline events): "
              f"{args.obs_out}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", action="store_true",
                    help="print scored placement plans only (no device)")
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--topology", default="all",
                    help=f"preset or 'all' (dryrun only): {PRESETS}")
    # placement shape (dryrun; serve derives ranks/tp from the mesh)
    ap.add_argument("--ranks", type=int, default=8,
                    help="rank slots in the modeled allocation (dryrun)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--tp", type=int, default=4,
                    help="tensor-parallel degree per replica (dryrun)")
    # serve shape
    ap.add_argument("--mesh", default="1,1",
                    help="data,model ranks of each replica, stacked on the "
                         "device (serve mode)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--slots", type=int, default=4,
                    help="KV pages per replica")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--prompt-len-min", type=int, default=8)
    ap.add_argument("--prompt-len-max", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--sessions", type=int, default=None,
                    help="tag requests with this many session ids "
                         "(the router's affinity signal)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--backend", default="auto", choices=("auto", "xla"))
    ap.add_argument("--seed", type=int, default=0)
    # elasticity events
    ap.add_argument("--drain", action="append", default=[],
                    metavar="TICK:REPLICA",
                    help="drain a replica at a fleet tick (repeatable)")
    ap.add_argument("--respawn", action="append", default=[],
                    metavar="TICK:REPLICA",
                    help="respawn a drained replica (repeatable)")
    # chaos / resilience (repro_torch.resilience)
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="generate a seed-driven crash/straggler schedule "
                         "and run under the self-healing supervisor")
    ap.add_argument("--chaos-events", action="append", default=[],
                    metavar="TICK:KIND:TARGET[:MAG]",
                    help="explicit fault events (repeatable; kinds: crash, "
                         "straggler); overrides --chaos-seed generation")
    ap.add_argument("--chaos-n-events", type=int, default=2,
                    help="events drawn when --chaos-seed generates the "
                         "schedule")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="hard fleet-tick budget; exceeding it exits "
                         "non-zero instead of looping (livelock guard)")
    # measured-latency feedback store
    ap.add_argument("--device-kind", default=None,
                    help="feedback-store key part; enables warm start")
    ap.add_argument("--save-feedback", action="store_true")
    ap.add_argument("--cold-start", action="store_true",
                    help="skip warm-starting routing from persisted "
                         "feedback")
    ap.add_argument("--timestamp", default=None,
                    help="recorded verbatim in saved feedback (never "
                         "auto-generated)")
    ap.add_argument("--obs-out", default=None, metavar="PATH",
                    help="write the run's observability artifact (metrics "
                         "registry + timeline + stats) as JSON for "
                         "repro_torch.launch.report")
    args = ap.parse_args(argv)

    if args.dryrun:
        run_dryrun(args)
        return
    if args.topology == "all":
        args.topology = "tpu_multipod"
    try:
        run_serve(args)
    except SystemExit:
        raise
    except Exception as e:
        # an unhandled serve-loop death (engine error without a chaos
        # supervisor, livelocked trace past --max-ticks, ...) must exit
        # non-zero with a summary, not return 0 with a buried traceback
        frame = traceback.extract_tb(e.__traceback__)[-1]
        summary = "".join(
            traceback.format_exception_only(type(e), e)).strip()
        print(f"[fleet] FATAL: serve loop died at {frame.filename}:"
              f"{frame.lineno} in {frame.name}: {summary}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
