"""Decision tables: ``(collective, p, size-bucket) -> backend``.

Port of ``repro.topology.table``.  A table is built once per topology
preset by brute-force argmin of ``cost.predict_time`` over
``cost.CANDIDATES`` on a (p, size) grid (``build_table``), then serialized
to JSON.  The five preset tables the JAX package ships are copied byte for
byte into ``tables/``; ``build_table`` with the reference's constants
rebuilds each of them byte for byte, and with ``hbm_bw`` set builds one
for another card's local memory beside them.  ``load_table`` reads the
packaged presets as the analytic base (a built table is saved and loaded
by the caller).

``entries[collective][p][i]`` is the backend for payloads in bucket ``i``
(``nbytes <= size_buckets[i]``, first match; larger payloads use the last
bucket).  A rank count off the grid snaps to the nearest grid point in
log-space.  ``wire_entries`` (format 3) holds the joint
``(backend, wire_dtype)`` decision for reduce_scatter and allgather.
``with_measured_cells`` and ``merge_measured`` overlay a tuner's measured
cells.

Measured tables live in their own directory (``REPRO_MEASURED_TABLE_DIR``,
default ``<cache>/measured`` with ``<cache>`` = ``REPRO_TABLE_DIR`` or
``~/.cache/repro-bine/tables``, the reference's paths), one
``<topology>.json`` each, written by either package's tuner
(``launch/tune.py``).  ``tuning="measured"`` merges
their measured cells over the analytic base at load time; a missing,
grid-stale, truncated or hand-edited file warns once per ``(topology, p,
tuning)`` and falls back to the analytic decisions, as in the reference.
The ``select_*`` lookups cache each loaded table per process
(``invalidate_tables`` drops them).
"""

from __future__ import annotations

import json
import math
import os
import warnings
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .cost import (CANDIDATES, HBM_BW, SMALL_CUTOFF_BYTES,
                   WIRE_CODEC_COLLECTIVES, candidates_for,
                   optimal_bucket_bytes, predict_time, wire_candidates)
from .presets import PRESETS, get_topology

_FORMAT = 3
#: formats ``from_json_dict`` accepts: 1 = pre-provenance, 2 = adds the
#: per-cell provenance map, 3 = adds the joint (backend, wire_dtype) rows
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

_PACKAGED_DIR = os.path.join(os.path.dirname(__file__), "tables")


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

    def measured_cell_count(self) -> int:
        return sum(row.count(MEASURED)
                   for per_p in self.provenance.values()
                   for row in per_p.values())

    def overrides_vs(self, base: "DecisionTable") -> int:
        """How many MEASURED cells pick a different backend than ``base``
        (the analytic table they were refreshed against)."""
        return sum(
            1 for c, per_p in self.entries.items()
            for p, row in per_p.items()
            for i, b in enumerate(row)
            if self.provenance_of(c, p, self.size_buckets[i]) == MEASURED
            and b != base.entries[c][p][i])

    def to_json_dict(self) -> dict:
        d = {
            "format": _FORMAT,
            "topology": self.topology,
            "small_cutoff_bytes": self.small_cutoff_bytes,
            "ps": list(self.ps),
            "size_buckets": list(self.size_buckets),
            "entries": {c: {str(p): list(row) for p, row in per_p.items()}
                        for c, per_p in self.entries.items()},
            "bucket_bytes": {str(p): int(v)
                             for p, v in self.bucket_bytes.items()},
        }
        if self.provenance:
            d["provenance"] = {
                c: {str(p): list(row) for p, row in per_p.items()}
                for c, per_p in self.provenance.items()}
        if self.wire_entries:
            d["wire_entries"] = {
                c: {str(p): [list(cell) for cell in row]
                    for p, row in per_p.items()}
                for c, per_p in self.wire_entries.items()}
        if self.wire_provenance:
            d["wire_provenance"] = {
                c: {str(p): list(row) for p, row in per_p.items()}
                for c, per_p in self.wire_provenance.items()}
        return d

    def to_json(self) -> str:
        """The file's text, as the reference's ``save`` writes it."""
        return json.dumps(self.to_json_dict(), indent=1, sort_keys=True) + "\n"

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "DecisionTable":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))

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


# ---------------------------------------------------------------------------
# Building
# ---------------------------------------------------------------------------

def build_table(topology: str,
                ps: Tuple[int, ...] = P_GRID,
                size_buckets: Tuple[int, ...] = SIZE_BUCKETS,
                small_cutoff_bytes: int = SMALL_CUTOFF_BYTES,
                hbm_bw: float = HBM_BW) -> DecisionTable:
    """Brute-force argmin of ``predict_time`` over the candidate backends.

    Each bucket is priced at its upper edge; ties break toward the earlier
    entry in ``CANDIDATES[collective]`` (deterministic across rebuilds).
    The ``wire_entries`` rows run the same argmin over the joint
    ``cost.wire_candidates`` grid for the codec collectives; the float32
    pairs enumerate first, so on a tie the uncompressed wire wins.
    ``hbm_bw`` is the local memory's rate (B/s) in every price; its
    default is the reference's, with which the packaged tables rebuild.
    """
    entries: Dict[str, Dict[int, Tuple[str, ...]]] = {}
    wire_entries: Dict[str, Dict[int, Tuple[Tuple[str, str], ...]]] = {}
    for collective in CANDIDATES:
        cands = candidates_for(collective, topology)
        wcands = wire_candidates(collective, topology)
        per_p: Dict[int, Tuple[str, ...]] = {}
        wire_per_p: Dict[int, Tuple[Tuple[str, str], ...]] = {}
        for p in ps:
            topo = get_topology(topology, p)
            row: List[str] = []
            wrow: List[Tuple[str, str]] = []
            for edge in size_buckets:
                best = min(cands, key=lambda b: predict_time(
                    collective, b, p, edge, topo, small_cutoff_bytes,
                    hbm_bw=hbm_bw))
                row.append(best)
                if collective in WIRE_CODEC_COLLECTIVES:
                    wrow.append(min(wcands, key=lambda bw: predict_time(
                        collective, bw[0], p, edge, topo,
                        small_cutoff_bytes, wire_dtype=bw[1],
                        hbm_bw=hbm_bw)))
            per_p[p] = tuple(row)
            if wrow:
                wire_per_p[p] = tuple(wrow)
        entries[collective] = per_p
        if wire_per_p:
            wire_entries[collective] = wire_per_p
    bucket_bytes = {p: optimal_bucket_bytes(
        p, get_topology(topology, p),
        small_cutoff_bytes=small_cutoff_bytes, hbm_bw=hbm_bw) for p in ps}
    return DecisionTable(topology=topology,
                         small_cutoff_bytes=small_cutoff_bytes,
                         ps=tuple(ps), size_buckets=tuple(size_buckets),
                         entries=entries, bucket_bytes=bucket_bytes,
                         wire_entries=wire_entries)


# ---------------------------------------------------------------------------
# Measured-cell merging (a tuner's output)
# ---------------------------------------------------------------------------

def with_measured_cells(base: DecisionTable,
                        cells: Dict[Tuple[str, int, int], str],
                        wire_cells: Optional[
                            Dict[Tuple[str, int, int],
                                 Tuple[str, str]]] = None
                        ) -> DecisionTable:
    """Overlay measured decisions onto ``base``.

    ``cells`` maps ``(collective, p, size-bucket index) -> backend``; every
    named cell takes the measured backend (``provenance_of`` says
    ``"measured"``) and every other cell keeps the analytic entry.  Cells
    off ``base``'s grid raise ``KeyError``.  ``wire_cells`` overlays the
    joint ``(backend, wire_dtype)`` rows the same way; a wire cell for a
    collective without a wire row raises too.
    """
    entries = {c: {p: list(row) for p, row in per_p.items()}
               for c, per_p in base.entries.items()}
    prov = {c: {p: [ANALYTIC] * len(row) for p, row in per_p.items()}
            for c, per_p in base.entries.items()}
    if base.provenance:  # keep measured cells already in the base
        for c, per_p in base.provenance.items():
            for p, row in per_p.items():
                prov[c][p] = list(row)
    nb = len(base.size_buckets)
    for (coll, p, bucket), backend in cells.items():
        if coll not in entries or p not in entries[coll] or not (
                0 <= bucket < nb):
            raise KeyError(f"measured cell ({coll}, {p}, {bucket}) is off "
                           f"the {base.topology!r} table grid")
        entries[coll][p][bucket] = backend
        prov[coll][p][bucket] = MEASURED
    wentries = {c: {p: list(row) for p, row in per_p.items()}
                for c, per_p in base.wire_entries.items()}
    wprov = {c: {p: [ANALYTIC] * len(row) for p, row in per_p.items()}
             for c, per_p in base.wire_entries.items()}
    if base.wire_provenance:
        for c, per_p in base.wire_provenance.items():
            for p, row in per_p.items():
                if c in wprov and p in wprov[c]:
                    wprov[c][p] = list(row)
    for (coll, p, bucket), pair in (wire_cells or {}).items():
        if coll not in wentries or p not in wentries[coll] or not (
                0 <= bucket < nb):
            raise KeyError(f"measured wire cell ({coll}, {p}, {bucket}) is "
                           f"off the {base.topology!r} table grid")
        wentries[coll][p][bucket] = (pair[0], pair[1])
        wprov[coll][p][bucket] = MEASURED
    return DecisionTable(
        topology=base.topology,
        small_cutoff_bytes=base.small_cutoff_bytes,
        ps=base.ps, size_buckets=base.size_buckets,
        entries={c: {p: tuple(row) for p, row in per_p.items()}
                 for c, per_p in entries.items()},
        bucket_bytes=dict(base.bucket_bytes),
        provenance={c: {p: tuple(row) for p, row in per_p.items()}
                    for c, per_p in prov.items()},
        wire_entries={c: {p: tuple(row) for p, row in per_p.items()}
                      for c, per_p in wentries.items()},
        wire_provenance={c: {p: tuple(row) for p, row in per_p.items()}
                         for c, per_p in wprov.items()})


def merge_measured(base: DecisionTable,
                   measured: DecisionTable) -> DecisionTable:
    """Merge a measured table's MEASURED cells over an analytic base.

    Both tables must share the (ps, size_buckets, small_cutoff) grid; a
    mismatch means the measured table is stale and raises ``ValueError``.
    """
    if (measured.ps != base.ps
            or measured.size_buckets != base.size_buckets
            or measured.small_cutoff_bytes != base.small_cutoff_bytes):
        raise ValueError(
            f"measured table grid for {base.topology!r} does not match the "
            f"analytic base (stale measured table? re-run launch/tune.py)")
    cells = {}
    for c, per_p in measured.provenance.items():
        for p, row in per_p.items():
            for i, src in enumerate(row):
                if src == MEASURED:
                    cells[(c, p, i)] = measured.entries[c][p][i]
    wire_cells = {}
    for c, per_p in measured.wire_provenance.items():
        for p, row in per_p.items():
            for i, src in enumerate(row):
                if src == MEASURED and c in base.wire_entries:
                    wire_cells[(c, p, i)] = measured.wire_entries[c][p][i]
    return with_measured_cells(base, cells, wire_cells)


# ---------------------------------------------------------------------------
# The packaged tables, the measured tables and the process cache
# ---------------------------------------------------------------------------

_LOADED: Dict[Tuple[str, str], DecisionTable] = {}

#: warning keys already emitted this process (see ``_warn_once``)
_WARNED: set = set()


def _warn_once(key, msg: str) -> None:
    """Emit ``msg`` at most once per process for ``key``: a bucketed train
    step alone makes dozens of lookups."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(msg, stacklevel=3)


def _cache_dir() -> str:
    env = os.environ.get("REPRO_TABLE_DIR")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-bine",
                        "tables")


def measured_dir() -> str:
    """Where measured tables live (``REPRO_MEASURED_TABLE_DIR``
    overrides)."""
    env = os.environ.get("REPRO_MEASURED_TABLE_DIR")
    if env:
        return env
    return os.path.join(_cache_dir(), "measured")


def measured_table_path(topology: str) -> str:
    return os.path.join(measured_dir(), f"{topology}.json")


def table_path(topology: str) -> str:
    """The packaged (analytic) table of a preset."""
    return os.path.join(_PACKAGED_DIR, f"{topology}.json")


def load_table(topology: str, tuning: str = ANALYTIC,
               p: Optional[int] = None) -> DecisionTable:
    """A packaged preset's table, with ``tuning="measured"`` the measured
    table's cells merged over it.

    A missing or unusable measured file (grid-stale, truncated,
    hand-edited) warns once per ``(topology, p, tuning)`` and returns the
    analytic table: auto-dispatch never fails because a machine was not
    tuned.  ``p`` only scopes that warning (the ``select_*`` lookups pass
    their rank count), so after ``invalidate_tables`` a run at a new rank
    count warns again."""
    if tuning not in TUNINGS:
        raise ValueError(f"unknown tuning {tuning!r}; expected one of "
                         f"{TUNINGS}")
    if topology not in PRESETS:
        raise ValueError(f"unknown topology {topology!r}; known: "
                         f"{list(PRESETS)}")
    base = DecisionTable.load(table_path(topology))
    if tuning != MEASURED:
        return base
    mpath = measured_table_path(topology)
    if not os.path.exists(mpath):
        _warn_once(("no-measured-table", topology, p, tuning),
                   f"tuning='measured' for topology {topology!r} but no "
                   f"measured table at {mpath}; falling back to analytic "
                   f"decisions")
        return base
    try:
        return merge_measured(base, DecisionTable.load(mpath))
    except (ValueError, KeyError, TypeError, OSError,
            json.JSONDecodeError) as e:
        _warn_once(("stale-measured-table", topology, p, tuning),
                   f"measured table {mpath} unusable ({e!r}); falling "
                   f"back to analytic decisions")
        return base


def _table_for(topology: str, tuning: str,
               p: Optional[int] = None) -> DecisionTable:
    key = (topology, tuning)
    table = _LOADED.get(key)
    if table is None:
        table = _LOADED[key] = load_table(topology, tuning, p)
    return table


def invalidate_tables(topology: Optional[str] = None) -> None:
    """Drop the per-process table cache (all presets, or one): the next
    lookup re-loads (and re-merges the measured cells of) the table, and a
    measured-table fallback warns again for a new rank count."""
    if topology is None:
        _LOADED.clear()
        return
    for key in [k for k in _LOADED if k[0] == topology]:
        del _LOADED[key]


def select_backend(collective: str, p: int, nbytes: float,
                   topology: str = "tpu_multipod",
                   tuning: str = ANALYTIC) -> str:
    """The ``backend="auto"`` lookup: the table's backend for this cell."""
    return _table_for(topology, tuning, p).lookup(collective, p, nbytes)


def decision_provenance(collective: str, p: int, nbytes: float,
                        topology: str = "tpu_multipod",
                        tuning: str = ANALYTIC) -> str:
    """"measured" | "analytic" for the cell ``select_backend`` would use."""
    return _table_for(topology, tuning, p).provenance_of(
        collective, p, nbytes)


def select_wire(collective: str, p: int, nbytes: float,
                topology: str = "tpu_multipod",
                tuning: str = ANALYTIC) -> Tuple[str, str]:
    """The ``wire_dtype="auto"`` lookup: joint ``(backend, wire)``.
    ``nbytes`` is the float32 full-vector payload, not pre-scaled."""
    return _table_for(topology, tuning, p).lookup_wire(
        collective, p, nbytes)


def wire_decision_provenance(collective: str, p: int, nbytes: float,
                             topology: str = "tpu_multipod",
                             tuning: str = ANALYTIC) -> str:
    """"measured" | "analytic" for the cell ``select_wire`` would use."""
    return _table_for(topology, tuning, p).wire_provenance_of(
        collective, p, nbytes)


def select_bucket_bytes(p: int, topology: str = "tpu_multipod",
                        tuning: str = ANALYTIC) -> int:
    """Gradient-bucket capacity in bytes for ``p`` DP ranks: the table's
    ``bucket_bytes`` entry at the nearest grid point (every packaged table
    carries the entry)."""
    table = _table_for(topology, tuning, p)
    q = p if p in table.bucket_bytes else table.nearest_p(p)
    return table.bucket_bytes[q]
