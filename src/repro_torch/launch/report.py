"""Run report CLI: render a recorded run's observability artifact.

Port of ``repro.launch.report``.  Reads a JSON artifact of the
``{"registry": ..., "timeline": ...}`` shape (``obs.metrics.Registry
.snapshot()`` and ``obs.timeline.Timeline.to_json_dict()``, with the
run's ``config``) and prints:

  * the **link-byte table** — global vs local bytes per (backend,
    topology), the paper's locality story as measured in this run;
  * the **decision table check** — the auto-selector's chosen backend
    per packaged preset at a representative (p, payload), one greppable
    ``preset=<name> ... chosen=<backend>`` line each;
  * the **drift table** — per-cell EWMA measured/predicted ratios from
    the drift store, with provenance and the cells flagged for retune;
  * the **latency summary** — the registry's histograms (nearest-rank
    p50/p99).

Usage::

  python -m repro_torch.launch.report --artifact out/run.json
  python -m repro_torch.launch.report --artifact out/run.json \
      --drift-dir /path/to/drift --prom out/metrics.prom \
      --trace-out out/trace.json
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Optional


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GiB"


def report_link_bytes(reg) -> None:
    from repro_torch.obs.collect import global_local_summary
    rows = global_local_summary(reg)
    print("[report] link bytes (schedule-attributed, this run):")
    if not rows:
        print("[report]   (no collective dispatches recorded)")
        return
    for (backend, topology), row in sorted(rows.items()):
        tot = row["global"] + row["local"]
        frac = row["global"] / tot if tot else 0.0
        print(f"[report]   backend={backend} topology={topology} "
              f"global={_fmt_bytes(row['global'])} "
              f"local={_fmt_bytes(row['local'])} "
              f"global_frac={frac:.3f}")


def report_chosen_backends(p: int, nbytes: int, tuning: str) -> None:
    """One greppable auto-selector line per packaged preset."""
    from repro_torch.topology import select_backend
    from repro_torch.topology.presets import PRESETS
    print(f"[report] decision table (p={p}, payload={nbytes}B, "
          f"tuning={tuning}):")
    for preset in PRESETS:
        try:
            chosen = select_backend("allreduce", p, nbytes, preset,
                                    tuning=tuning)
        except Exception as e:
            print(f"[report]   preset={preset} p={p} nbytes={nbytes} "
                  f"chosen=ERROR ({e})")
            continue
        print(f"[report]   preset={preset} p={p} nbytes={nbytes} "
              f"collective=allreduce chosen={chosen}")


def report_drift(topology: Optional[str], drift_dir: Optional[str],
                 threshold: Optional[float]) -> None:
    from repro_torch.obs import drift as D
    thr = threshold if threshold is not None else D.DEFAULT_THRESHOLD
    dsets = D.load_all_drift(topology=topology, dir=drift_dir)
    print("[report] drift (EWMA measured/predicted per decision cell):")
    if not dsets:
        print("[report]   (no drift store entries)")
        return
    for ds in dsets:
        prov = ds.provenance
        print(f"[report]   store {ds.key()}: device={ds.device_kind} "
              f"topology={ds.topology} p={ds.p} "
              f"timestamp={prov.get('timestamp')} "
              f"source={prov.get('grid') or prov.get('source')}")
        flagged = {h.collective + f"/b{h.bucket}"
                   for h in D.hints(ds, thr)}
        for key, c in sorted(ds.cells.items()):
            mark = "  <-- RETUNE" if key in flagged else ""
            print(f"[report]     {key}: ratio="
                  f"{math.exp(c.ewma_log_ratio):.2f} n={c.n} "
                  f"last={c.last_backend}/{c.last_wire} "
                  f"@{c.last_nbytes}B{mark}")
        if flagged:
            print(f"[report]   {len(flagged)} cell(s) drifted past "
                  f"|ln ratio| > {thr:.3f}: refresh with "
                  f"`python -m repro_torch.launch.tune --hints "
                  f"--topology {ds.topology}`")


def report_latency(reg) -> None:
    print("[report] latency histograms (nearest-rank):")
    rows = [(name, dict(lk), h) for (name, lk), h
            in sorted(reg.histograms.items())]
    if not rows:
        print("[report]   (no histograms recorded)")
        return
    for name, labels, h in rows:
        lbl = " ".join(f"{k}={v}" for k, v in sorted(labels.items()))
        print(f"[report]   {name}{' ' + lbl if lbl else ''}: "
              f"n={h.count} p50={h.quantile(50):.4g} "
              f"p99={h.quantile(99):.4g}")


def report_counters(reg) -> None:
    interesting = ("fleet_crashes", "fleet_drains", "fleet_respawns",
                   "fleet_shed", "fleet_requeued", "chaos_events",
                   "serve_requests_retired", "collective_calls")
    lines = []
    for name in interesting:
        for labels, value in reg.series(name):
            lbl = " ".join(f"{k}={v}" for k, v in sorted(labels.items()))
            lines.append(f"[report]   {name}"
                         f"{' ' + lbl if lbl else ''} = {value:g}")
    if lines:
        print("[report] counters:")
        for ln in lines:
            print(ln)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render a run report from a recorded obs artifact")
    ap.add_argument("--artifact", required=True,
                    help="JSON artifact: a registry snapshot and a timeline")
    ap.add_argument("--p", type=int, default=8,
                    help="rank count for the decision-table check lines")
    ap.add_argument("--nbytes", type=int, default=1 << 20,
                    help="payload for the decision-table check lines")
    ap.add_argument("--tuning", default="analytic",
                    choices=("analytic", "measured"),
                    help="decision-table provenance for the check lines")
    ap.add_argument("--drift-dir", default=None,
                    help="drift store override (REPRO_DRIFT_DIR)")
    ap.add_argument("--drift-threshold", type=float, default=None)
    ap.add_argument("--topology", default=None,
                    help="restrict the drift table to one preset "
                         "(default: the artifact's topology)")
    ap.add_argument("--prom", default=None, metavar="PATH",
                    help="also write the registry as Prometheus text")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="also write the Perfetto/Chrome-trace JSON")
    args = ap.parse_args(argv)

    from repro_torch.obs import metrics, timeline

    try:
        with open(args.artifact) as f:
            artifact = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"[report] cannot read artifact {args.artifact}: {e!r}",
              file=sys.stderr)
        return 1

    reg = metrics.Registry.from_snapshot(artifact.get("registry", {}))
    tl = timeline.Timeline.from_json_dict(artifact.get("timeline", []))
    cfg = artifact.get("config", {})
    topology = args.topology or cfg.get("topology")

    print(f"[report] artifact {args.artifact}: "
          f"kind={artifact.get('kind')} "
          f"timestamp={artifact.get('timestamp')} "
          f"config={json.dumps(cfg, sort_keys=True)}")
    print(f"[report] timeline: {len(tl)} events")

    report_link_bytes(reg)
    report_chosen_backends(args.p, args.nbytes, args.tuning)
    report_drift(topology, args.drift_dir, args.drift_threshold)
    report_latency(reg)
    report_counters(reg)

    if args.prom:
        with open(args.prom, "w") as f:
            f.write(timeline.export_prom(reg))
        print(f"[report] prometheus text -> {args.prom}")
    if args.trace_out:
        timeline.dump_chrome_trace(tl, args.trace_out)
        print(f"[report] chrome trace ({len(tl)} events) -> "
              f"{args.trace_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
