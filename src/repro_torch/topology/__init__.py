"""Topology-aware backend selection: the packaged decision tables.

Port of the read side of ``repro.topology``: ``select_backend`` behind
``CollectiveConfig(backend="auto")``, ``select_wire`` behind
``wire_dtype="auto"``, and ``select_bucket_bytes`` behind
``TrainConfig(bucket_bytes=-1)``, all reading the five preset tables the
JAX package ships (byte copies under ``tables/``).
"""

from .table import (ANALYTIC, CANDIDATES, MEASURED, P_GRID, PRESETS,
                    SIZE_BUCKETS, SMALL_CUTOFF_BYTES, TUNINGS, DecisionTable,
                    decision_provenance, load_table, select_backend,
                    select_bucket_bytes, select_wire, table_path,
                    wire_decision_provenance)

__all__ = [
    "ANALYTIC", "CANDIDATES", "MEASURED", "P_GRID", "PRESETS",
    "SIZE_BUCKETS", "SMALL_CUTOFF_BYTES", "TUNINGS", "DecisionTable",
    "decision_provenance", "load_table", "select_backend",
    "select_bucket_bytes", "select_wire", "table_path",
    "wire_decision_provenance",
]
