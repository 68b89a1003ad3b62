"""Empirical autotuner: the measurement plane under ``backend="auto"``.

Port of ``repro.tuner``.  The analytic α-β model in ``topology.cost``
predicts which collective backend wins each (collective, p, payload)
cell; this package closes the loop with *measured* evidence:

  * ``probe``   — microbenchmark harness that times the real collectives
    (the stacked schedules and the ``pallas_fused`` step kernels) through
    ``collectives.api`` on one device over a (collective × backend ×
    payload × p) grid;
  * ``trace``   — schedule-replay link tracer: maps every wire step of a
    ``core.schedules`` schedule onto a topology and records per-link byte
    counters (local vs global split), which ``obs.collect`` attributes
    link bytes with;
  * ``store``   — on-disk measurement cache keyed by
    (device_kind, topology, p) with provenance metadata, in the
    reference's format;
  * ``refresh`` — rebuilds ``DecisionTable`` entries from measurements
    (``provenance: "measured"``), blending back to the analytic
    predictions for unmeasured cells.

Entry points: ``launch/tune.py`` runs the grid and writes the measured
table; ``CollectiveConfig(tuning="measured")`` (and the train
equivalent) makes ``backend="auto"`` dispatch from it.
"""

from .probe import GRIDS, GridSpec, probe_grid, time_collective, trimmed_median
from .refresh import measured_cells, refresh_from_store, refresh_table
from .store import (Measurement, MeasurementSet, load_all_measurements,
                    load_measurements, save_measurements, store_dir)
from .trace import (TraceResult, replayed_reduction, trace_collective,
                    trace_schedule)

__all__ = [
    "GRIDS", "GridSpec", "probe_grid", "time_collective", "trimmed_median",
    "measured_cells", "refresh_from_store", "refresh_table",
    "Measurement", "MeasurementSet", "load_all_measurements",
    "load_measurements", "save_measurements", "store_dir",
    "TraceResult", "replayed_reduction", "trace_collective",
    "trace_schedule",
]
