"""Empirical autotune CLI: probe the device, write the measured table.

Port of ``repro.launch.tune``.  Runs the ``repro_torch.tuner`` probe grid
(the real collectives through ``collectives.api`` — the stacked schedules
and the ``pallas_fused`` step kernels — with warmup and trimmed-median
timing), files the measurements in the on-disk store, folds them into
the drift store, refreshes the topology's decision table from them, and
writes the measured table where ``tuning="measured"`` dispatch finds it.

Usage::

  python -m repro_torch.launch.tune --grid small --topology lumi
  python -m repro_torch.launch.tune --grid tiny --topology tpu_multipod \\
      --device cpu --timestamp "$(git rev-parse --short HEAD)"

Every rank count of the grid runs stacked on the one device (the card
unless ``--device cpu``): the table it writes is a fact about the
stacked executor and its kernels on that device, not about links.  On
the CPU the ``pallas_fused`` cells run the kernels' plain versions —
wiring-correct, not performance-representative.

Environment: ``REPRO_MEASURE_DIR`` relocates the measurement store,
``REPRO_DRIFT_DIR`` the drift store, ``REPRO_MEASURED_TABLE_DIR`` the
measured tables.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="probe collective timings and refresh the measured "
                    "decision table")
    ap.add_argument("--grid", default="tiny",
                    help="probe grid name (tiny | small | full)")
    ap.add_argument("--topology", default="tpu_multipod",
                    help="decision-table preset the measurements tune")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device every rank count runs stacked on")
    ap.add_argument("--timestamp", default=None,
                    help="caller-supplied provenance string recorded "
                         "verbatim (never auto-generated)")
    ap.add_argument("--store-dir", default=None,
                    help="measurement store override (REPRO_MEASURE_DIR)")
    ap.add_argument("--table-out", default=None,
                    help="measured-table path override (default: "
                         "topology.measured_table_path)")
    ap.add_argument("--merge-store", action="store_true",
                    help="refresh from all cached measurements for this "
                         "(topology, device kind), not just this run's")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="per-cell wall-clock budget in seconds (warmup + "
                         "reps); a cell past it is retried then skipped, "
                         "the rest of the grid still measured")
    ap.add_argument("--retries", type=int, default=None,
                    help="extra attempts per timed-out/failed cell before "
                         "skipping it (default: the grid's own setting)")
    ap.add_argument("--backoff-s", type=float, default=None,
                    help="sleep between a cell's attempts, seconds "
                         "(linear: attempt * backoff)")
    ap.add_argument("--dry", action="store_true",
                    help="list the grid cells and exit without timing")
    ap.add_argument("--hints", action="store_true",
                    help="probe only the cells the drift store flags as "
                         "mis-priced (obs.drift retune hints) instead of "
                         "the full grid; exits 0 with no work when nothing "
                         "drifted")
    ap.add_argument("--drift-dir", default=None,
                    help="drift store override (REPRO_DRIFT_DIR)")
    ap.add_argument("--drift-threshold", type=float, default=None,
                    help="|EWMA log(measured/predicted)| above which a "
                         "cell counts as drifted (default ln(1.5))")
    args = ap.parse_args(argv)

    from repro_torch.obs import drift
    from repro_torch.topology import PRESETS, load_table, measured_table_path
    from repro_torch.tuner import (GRIDS, load_all_measurements, probe_grid,
                                   refresh_table, save_measurements)
    from repro_torch.tuner.probe import grid_cells

    if args.grid not in GRIDS:
        ap.error(f"unknown grid {args.grid!r}; known: {sorted(GRIDS)}")
    if args.topology not in PRESETS:
        ap.error(f"unknown topology {args.topology!r}; known: {PRESETS}")
    spec = GRIDS[args.grid]
    overrides = {k: v for k, v in (("budget_s", args.budget_s),
                                   ("retries", args.retries),
                                   ("backoff_s", args.backoff_s))
                 if v is not None}
    if overrides:
        spec = dataclasses.replace(spec, **overrides)

    if args.hints:
        thr = (args.drift_threshold if args.drift_threshold is not None
               else drift.DEFAULT_THRESHOLD)
        dsets = drift.load_all_drift(topology=args.topology,
                                     dir=args.drift_dir)
        all_hints = [h for ds in dsets for h in drift.hints(ds, thr)
                     if h.collective in spec.collectives]
        if not all_hints:
            print("[tune] no drifted cells; decision table is current")
            return 0
        for h in all_hints:
            print(f"[tune] drift hint: {h.collective} p={h.p} "
                  f"bucket~{h.nbytes}B measured/predicted={h.ratio:.2f} "
                  f"(n={h.n}, last={h.last_backend})")
        # restrict the grid to the drifted cells' axes: a stale table
        # refreshes in seconds instead of re-sweeping everything
        spec = dataclasses.replace(
            spec, name=f"{spec.name}+hints",
            collectives=tuple(sorted({h.collective for h in all_hints})),
            sizes=tuple(sorted({drift.bucket_bytes(h.bucket)
                                for h in all_hints})),
            ps=tuple(sorted({h.p for h in all_hints})))

    if args.dry:
        for p in spec.ps:
            for nbytes, coll, backend, wire in grid_cells(spec,
                                                          args.topology):
                print(f"{coll} {backend} {wire} p={p} {nbytes}B")
        return 0

    print(f"[tune] grid={spec.name} topology={args.topology} "
          f"ps={spec.ps} sizes={spec.sizes} device={args.device}")
    sets = probe_grid(spec, args.topology, timestamp=args.timestamp,
                      progress=True, device=args.device)
    if not any(ms.measurements for ms in sets):
        print("[tune] no cells measured (not enough device memory?)",
              file=sys.stderr)
        return 1
    for ms in sets:
        path = save_measurements(ms, args.store_dir)
        if path is not None:
            print(f"[tune] wrote {len(ms.measurements)} measurements "
                  f"-> {path}")

    # probe measurements double as drift samples: fold them into the
    # per-(device, topology, p) residual store the --hints mode reads
    for ms in sets:
        if not ms.measurements:
            continue
        base_d = drift.load_drift(ms.device_kind, args.topology, ms.p,
                                  dir=args.drift_dir)
        dset = drift.ingest_measurements(ms, topology=args.topology,
                                         base=base_d)
        dpath = drift.save_drift(dset, dir=args.drift_dir)
        if dpath is not None:
            print(f"[tune] drift residuals ({len(dset.cells)} cells) "
                  f"-> {dpath}")

    base = load_table(args.topology)
    if args.merge_store:
        # filter by THIS machine's device kind: medians across unrelated
        # hardware (a CPU smoke run + a card's run) would rank candidates
        # by an average of two different machines and suit neither
        flat = [m for ms2 in load_all_measurements(
            topology=args.topology, dir=args.store_dir,
            device_kind=sets[0].device_kind)
            for m in ms2.measurements]
    else:
        flat = [m for ms2 in sets for m in ms2.measurements]
    table = refresh_table(args.topology, flat, base=base)

    out = args.table_out or measured_table_path(args.topology)
    table.save(out)
    n_meas = table.measured_cell_count()
    n_cells = sum(len(row) for per_p in table.entries.values()
                  for row in per_p.values())
    n_over = table.overrides_vs(base)
    print(f"[tune] measured table -> {out}")
    print(f"[tune] {n_meas}/{n_cells} cells measured, "
          f"{n_over} override the analytic choice")
    print(json.dumps({"grid": spec.name, "topology": args.topology,
                      "measured_cells": n_meas, "total_cells": n_cells,
                      "analytic_overrides": n_over, "table": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
