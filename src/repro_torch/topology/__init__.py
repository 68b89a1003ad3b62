"""Topology-aware backend selection.

Port of ``repro.topology``: the presets (``presets``), the α-β cost model
(``cost.predict_time``), and the decision tables (``table``):
``select_backend`` behind ``CollectiveConfig(backend="auto")``,
``select_wire`` behind ``wire_dtype="auto"`` and ``select_bucket_bytes``
behind ``TrainConfig(bucket_bytes=-1)``, all reading the five preset
tables the JAX package ships (byte copies under ``tables/``), which
``build_table`` rebuilds, with a tuner's measured table merged over them
under ``tuning="measured"`` (``table.measured_dir``).
"""

from .cost import (BUCKET_SIZE_CANDIDATES, CANDIDATES, HBM_BW,
                   SMALL_CUTOFF_BYTES, WIRE_CODEC_BACKENDS,
                   WIRE_CODEC_COLLECTIVES, candidates_for, hbm_passes,
                   optimal_bucket_bytes, predict_bucket_time, predict_time,
                   schedule_algo, wire_candidates)
from .presets import (PRESETS, get_topology, tier_split, tier_split_or_none,
                      torus_dims)
from .table import (ANALYTIC, MEASURED, P_GRID, SIZE_BUCKETS, TUNINGS,
                    DecisionTable, build_table, decision_provenance,
                    invalidate_tables, load_table, measured_dir,
                    measured_table_path, merge_measured, select_backend,
                    select_bucket_bytes, select_wire, table_path,
                    wire_decision_provenance, with_measured_cells)

__all__ = [
    "BUCKET_SIZE_CANDIDATES", "CANDIDATES", "HBM_BW", "SMALL_CUTOFF_BYTES",
    "WIRE_CODEC_BACKENDS", "WIRE_CODEC_COLLECTIVES",
    "candidates_for", "hbm_passes", "optimal_bucket_bytes",
    "predict_bucket_time", "predict_time", "schedule_algo",
    "wire_candidates",
    "PRESETS", "get_topology", "tier_split", "tier_split_or_none",
    "torus_dims",
    "ANALYTIC", "MEASURED", "P_GRID", "SIZE_BUCKETS", "TUNINGS",
    "DecisionTable", "build_table", "decision_provenance",
    "invalidate_tables", "load_table", "measured_dir",
    "measured_table_path", "merge_measured", "select_backend", "select_bucket_bytes",
    "select_wire", "table_path", "wire_decision_provenance",
    "with_measured_cells",
]
