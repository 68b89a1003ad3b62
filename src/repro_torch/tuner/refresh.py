"""Rebuild ``DecisionTable`` cells from measurements.

Port of ``repro.tuner.refresh``: the same measurements give the same
table, byte for byte (``to_json``).  A decision-table cell (collective,
p, size-bucket) flips from analytic to measured when the probe has timed
**every** candidate backend the table minimizes over
(``topology.CANDIDATES``) for that cell — a partially measured cell keeps
the analytic prediction, because an argmin over a subset silently biases
toward whichever backends happened to get probed.

Per (cell, backend), multiple measurements (repeat runs, several payloads
landing in one size bucket) reduce by median; the cell's backend is the
argmin of those medians, ties breaking toward the earlier entry in
``CANDIDATES[collective]`` exactly like ``build_table``, so refresh
is deterministic given a measurement store.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.topology import CANDIDATES
from repro_torch.topology.cost import wire_candidates
from repro_torch.topology.table import (DecisionTable, load_table,
                                        with_measured_cells)
from repro_torch.tuner.store import (Measurement, MeasurementSet,
                                     load_all_measurements)

#: a measured decision: (collective, p, size-bucket index) -> backend
Cells = Dict[Tuple[str, int, int], str]

#: a measured joint decision: cell -> (backend, wire_dtype)
WireCells = Dict[Tuple[str, int, int], Tuple[str, str]]


def _median(xs: List[float]) -> float:
    ys = sorted(xs)
    mid = len(ys) // 2
    if len(ys) % 2:
        return ys[mid]
    return 0.5 * (ys[mid - 1] + ys[mid])


def measured_cells(base: DecisionTable,
                   measurements: Iterable[Measurement]) -> Cells:
    """Map raw measurements onto ``base``'s grid; keep fully-covered cells.

    Measurements for unknown collectives/backends (a store written by a
    newer probe) or off-grid rank counts are ignored rather than snapped:
    a measured decision must describe exactly the cell it claims.
    """
    times: Dict[Tuple[str, int, int, str], List[float]] = {}
    for m in measurements:
        if m.wire_dtype != "float32":
            continue  # backend rows are float32-pinned, like the table's
        cands = CANDIDATES.get(m.collective)
        if cands is None or m.backend not in cands or m.p not in base.ps:
            continue
        bucket = base.bucket_of(m.nbytes)
        times.setdefault((m.collective, m.p, bucket, m.backend),
                         []).append(m.time_s)

    cells: Cells = {}
    covered = {(c, p, b) for (c, p, b, _) in times}
    for coll, p, bucket in sorted(covered):
        cands = CANDIDATES[coll]
        medians = {}
        for backend in cands:
            ts = times.get((coll, p, bucket, backend))
            if not ts:
                break  # partial coverage: stay analytic
            medians[backend] = _median(ts)
        else:
            cells[(coll, p, bucket)] = min(
                cands, key=lambda b: medians[b])  # tie -> candidate order
    return cells


def measured_wire_cells(base: DecisionTable,
                        measurements: Iterable[Measurement]) -> WireCells:
    """Joint ``(backend, wire)`` decisions from measurements.

    Same full-coverage rule as ``measured_cells``, over the joint
    ``cost.wire_candidates`` grid: a wire cell only flips to measured
    when *every* (backend, wire) pair the table minimizes over was timed
    — a sweep that probed the codec variants but skipped a plain backend
    (or vice versa) keeps the analytic joint decision.  Only collectives
    ``base`` carries wire rows for are considered.
    """
    times: Dict[Tuple[str, int, int, Tuple[str, str]], List[float]] = {}
    for m in measurements:
        if m.collective not in base.wire_entries or m.p not in base.ps:
            continue
        pairs = wire_candidates(m.collective, base.topology)
        if (m.backend, m.wire_dtype) not in pairs:
            continue
        bucket = base.bucket_of(m.nbytes)
        times.setdefault(
            (m.collective, m.p, bucket, (m.backend, m.wire_dtype)),
            []).append(m.time_s)

    cells: WireCells = {}
    covered = {(c, p, b) for (c, p, b, _) in times}
    for coll, p, bucket in sorted(covered):
        pairs = wire_candidates(coll, base.topology)
        medians = {}
        for bw in pairs:
            ts = times.get((coll, p, bucket, bw))
            if not ts:
                break  # partial (backend, wire) coverage: stay analytic
            medians[bw] = _median(ts)
        else:
            cells[(coll, p, bucket)] = min(
                pairs, key=lambda bw: medians[bw])  # tie -> f32 first
    return cells


def refresh_table(topology: str,
                  measurements: Iterable[Measurement],
                  base: Optional[DecisionTable] = None) -> DecisionTable:
    """Measured table for ``topology``: analytic base + measured cells.

    The result is a complete table (every unmeasured cell blends back to
    the analytic prediction) whose ``provenance`` map says exactly which
    cells the measurements decided — ready to be saved to
    ``topology.measured_table_path`` and merged at load time by
    ``tuning="measured"``.  Wire rows refresh the same way, each joint
    cell needing full (backend, wire) coverage.
    """
    if base is None:
        base = load_table(topology)
    measurements = list(measurements)
    return with_measured_cells(base, measured_cells(base, measurements),
                               measured_wire_cells(base, measurements))


def refresh_from_store(topology: str,
                       store_dir: Optional[str] = None,
                       device_kind: Optional[str] = None,
                       base: Optional[DecisionTable] = None
                       ) -> Tuple[DecisionTable, List[MeasurementSet]]:
    """``refresh_table`` over every cached measurement set for a topology.

    Returns (table, sets used) so callers can report provenance.
    """
    sets = load_all_measurements(topology=topology, dir=store_dir,
                                 device_kind=device_kind)
    flat = [m for ms in sets for m in ms.measurements]
    return refresh_table(topology, flat, base=base), sets
