"""Decision tables: ``(collective, p, size-bucket) -> backend``.

The read side of ``repro.topology.table``: the five preset tables packaged
with the JAX package, copied byte for byte into ``topology/tables/``, are
parsed (formats 1-3) and looked up exactly as the reference does.  The
tables are built by the reference's cost model (``repro.topology.cost``),
which the port does not carry: ``build_table`` is not ported, and only the
packaged presets load.

``entries[collective][p][i]`` is the backend for payloads in bucket ``i``
(``nbytes <= size_buckets[i]``, first match; larger payloads use the last
bucket).  A rank count off the grid snaps to the nearest grid point in
log-space.  ``wire_entries`` (format 3) holds the joint
``(backend, wire_dtype)`` decision for reduce_scatter and allgather.
"""

from __future__ import annotations

import json
import math
import os
from bisect import bisect_left
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Tuple

_COMPAT_FORMATS = (1, 2, 3)

#: decision provenance values
ANALYTIC = "analytic"
MEASURED = "measured"

#: valid ``tuning=`` values
TUNINGS = (ANALYTIC, MEASURED)

#: rank-count grid: powers of two, the domain of every paper schedule
P_GRID: Tuple[int, ...] = (4, 8, 16, 32, 64, 128)

#: inclusive upper edges (bytes) of the payload buckets: 256 B .. 256 MiB
SIZE_BUCKETS: Tuple[int, ...] = tuple(1 << k for k in range(8, 29, 2))

#: allreduce small/large switch the tables were priced at (inclusive)
SMALL_CUTOFF_BYTES = 16384

#: backends the tables minimize over, per collective (the reference's
#: ``cost.CANDIDATES``); for the rooted collectives "recdoub" selects the
#: binomial-tree family in ``collectives.api``
CANDIDATES: Dict[str, Tuple[str, ...]] = {
    "allreduce": ("bine", "recdoub", "ring", "pallas_fused", "bine_hier"),
    "reduce_scatter": ("bine", "recdoub", "ring", "pallas_fused",
                       "bine_hier"),
    "allgather": ("bine", "recdoub", "ring", "pallas_fused", "bine_hier"),
    "alltoall": ("bine", "recdoub", "bruck"),
    "broadcast": ("bine", "recdoub"),
    "reduce": ("bine", "recdoub"),
    "gather": ("bine", "recdoub"),
    "scatter": ("bine", "recdoub"),
}

#: the packaged presets, one table each under ``tables/``
PRESETS: Tuple[str, ...] = ("leonardo", "lumi", "marenostrum5", "torus",
                            "tpu_multipod")

_PACKAGED_DIR = os.path.join(os.path.dirname(__file__), "tables")

#: where ``tuning="measured"`` is queued
_MEASURED_ITEM = ("ROADMAP.md queue A item 1 (the tuner's measured tables, "
                  "tuning='measured')")


@dataclass(frozen=True)
class DecisionTable:
    topology: str
    small_cutoff_bytes: int
    ps: Tuple[int, ...]
    size_buckets: Tuple[int, ...]
    # collective -> p -> [backend per size bucket]
    entries: Dict[str, Dict[int, Tuple[str, ...]]]
    # p -> gradient-bucket capacity (bytes)
    bucket_bytes: Dict[int, int] = field(default_factory=dict)
    # collective -> p -> ["measured"|"analytic" per size bucket]; empty =
    # every decision is analytic (format-1 tables)
    provenance: Dict[str, Dict[int, Tuple[str, ...]]] = \
        field(default_factory=dict)
    # collective -> p -> [(backend, wire_dtype) per size bucket]; empty on
    # format-1/2 tables
    wire_entries: Dict[str, Dict[int, Tuple[Tuple[str, str], ...]]] = \
        field(default_factory=dict)
    wire_provenance: Dict[str, Dict[int, Tuple[str, ...]]] = \
        field(default_factory=dict)

    def bucket_of(self, nbytes: float) -> int:
        i = bisect_left(self.size_buckets, nbytes)
        return min(i, len(self.size_buckets) - 1)

    def nearest_p(self, p: int) -> int:
        if p in self.ps:
            return p
        lg = math.log2(max(p, 1))
        return min(self.ps, key=lambda q: (abs(math.log2(q) - lg), -q))

    def lookup(self, collective: str, p: int, nbytes: float) -> str:
        per_p = self.entries[collective]
        q = p if p in per_p else self.nearest_p(p)
        return per_p[q][self.bucket_of(nbytes)]

    def provenance_of(self, collective: str, p: int, nbytes: float) -> str:
        """Where the ``lookup`` decision for this cell came from."""
        per_p = self.provenance.get(collective)
        if not per_p:
            return ANALYTIC
        q = p if p in per_p else self.nearest_p(p)
        row = per_p.get(q)
        return row[self.bucket_of(nbytes)] if row else ANALYTIC

    def lookup_wire(self, collective: str, p: int,
                    nbytes: float) -> Tuple[str, str]:
        """Joint ``(backend, wire_dtype)`` decision for this cell; without a
        wire row, the float32-pinned backend decision at float32."""
        per_p = self.wire_entries.get(collective)
        if not per_p:
            return self.lookup(collective, p, nbytes), "float32"
        q = p if p in per_p else self.nearest_p(p)
        row = per_p.get(q)
        if not row:
            return self.lookup(collective, p, nbytes), "float32"
        return row[self.bucket_of(nbytes)]

    def wire_provenance_of(self, collective: str, p: int,
                           nbytes: float) -> str:
        """Where the ``lookup_wire`` decision for this cell came from."""
        per_p = self.wire_provenance.get(collective)
        if not per_p:
            return ANALYTIC
        q = p if p in per_p else self.nearest_p(p)
        row = per_p.get(q)
        return row[self.bucket_of(nbytes)] if row else ANALYTIC

    @classmethod
    def from_json_dict(cls, d: dict) -> "DecisionTable":
        if d.get("format") not in _COMPAT_FORMATS:
            raise ValueError(
                f"unsupported decision-table format {d.get('format')!r}")
        return cls(
            topology=d["topology"],
            small_cutoff_bytes=int(d["small_cutoff_bytes"]),
            ps=tuple(int(p) for p in d["ps"]),
            size_buckets=tuple(int(s) for s in d["size_buckets"]),
            entries={c: {int(p): tuple(row) for p, row in per_p.items()}
                     for c, per_p in d["entries"].items()},
            bucket_bytes={int(p): int(v)
                          for p, v in d.get("bucket_bytes", {}).items()},
            provenance={c: {int(p): tuple(row) for p, row in per_p.items()}
                        for c, per_p in d.get("provenance", {}).items()},
            wire_entries={
                c: {int(p): tuple((cell[0], cell[1]) for cell in row)
                    for p, row in per_p.items()}
                for c, per_p in d.get("wire_entries", {}).items()},
            wire_provenance={
                c: {int(p): tuple(row) for p, row in per_p.items()}
                for c, per_p in d.get("wire_provenance", {}).items()},
        )


def table_path(topology: str) -> str:
    return os.path.join(_PACKAGED_DIR, f"{topology}.json")


@lru_cache(maxsize=None)
def load_table(topology: str, tuning: str = ANALYTIC) -> DecisionTable:
    """A packaged preset's table, parsed once per process."""
    if tuning not in TUNINGS:
        raise ValueError(f"unknown tuning {tuning!r}; expected one of "
                         f"{TUNINGS}")
    if tuning == MEASURED:
        raise NotImplementedError(
            f"tuning='measured' is not ported: {_MEASURED_ITEM}")
    if topology not in PRESETS:
        raise ValueError(f"unknown topology {topology!r}; known: "
                         f"{list(PRESETS)}")
    with open(table_path(topology)) as f:
        return DecisionTable.from_json_dict(json.load(f))


def select_backend(collective: str, p: int, nbytes: float,
                   topology: str = "tpu_multipod",
                   tuning: str = ANALYTIC) -> str:
    """The ``backend="auto"`` lookup: the table's backend for this cell."""
    return load_table(topology, tuning).lookup(collective, p, nbytes)


def decision_provenance(collective: str, p: int, nbytes: float,
                        topology: str = "tpu_multipod",
                        tuning: str = ANALYTIC) -> str:
    """"measured" | "analytic" for the cell ``select_backend`` would use."""
    return load_table(topology, tuning).provenance_of(collective, p, nbytes)


def select_wire(collective: str, p: int, nbytes: float,
                topology: str = "tpu_multipod",
                tuning: str = ANALYTIC) -> Tuple[str, str]:
    """The ``wire_dtype="auto"`` lookup: joint ``(backend, wire)``.
    ``nbytes`` is the float32 full-vector payload, not pre-scaled."""
    return load_table(topology, tuning).lookup_wire(collective, p, nbytes)


def wire_decision_provenance(collective: str, p: int, nbytes: float,
                             topology: str = "tpu_multipod",
                             tuning: str = ANALYTIC) -> str:
    """"measured" | "analytic" for the cell ``select_wire`` would use."""
    return load_table(topology, tuning).wire_provenance_of(
        collective, p, nbytes)


def select_bucket_bytes(p: int, topology: str = "tpu_multipod",
                        tuning: str = ANALYTIC) -> int:
    """Gradient-bucket capacity in bytes for ``p`` DP ranks: the table's
    ``bucket_bytes`` entry at the nearest grid point (every packaged table
    carries the entry)."""
    table = load_table(topology, tuning)
    q = p if p in table.bucket_bytes else table.nearest_p(p)
    return table.bucket_bytes[q]
