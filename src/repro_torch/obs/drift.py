"""Predicted-vs-measured drift: EWMA residuals per decision-table cell.

Port of ``repro.obs.drift``: the same cells, thresholds, file format and
environment variable, so a drift store written by either package loads
in the other.  The decision tables behind ``backend="auto"`` are only as
good as ``topology.cost.predict_time`` — and the model goes stale: a
software update changes a kernel's speed, a colocated job steals memory
bandwidth, a preset's β was fit on another machine.  Every measured
collective time — tuner probe cells and benchmark timings alike — is
compared against the model's prediction *for the same (collective,
backend, p, payload, wire)*, and the log-ratio residual

    r = ln(measured / predicted)

is folded into an EWMA per decision-table cell ``(collective, p,
payload-bucket)``.  Cells whose |EWMA| exceeds the threshold become
**retune hints**: ``launch/tune.py --hints`` probes exactly those cells
instead of the full grid, so a drifted table refreshes in seconds.

Storage follows the ``tuner.store`` pattern to the letter: one JSON file
per ``(device_kind, topology, p)`` under ``REPRO_DRIFT_DIR`` (default
``~/.cache/repro-bine/drift``), atomic writes, caller-supplied timestamps
recorded verbatim, corrupt files quarantined (``.corrupt``) with one
warning per path, unwritable dirs warned once instead of raised.
"""

from __future__ import annotations

import json
import math
import os
import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_FORMAT = 1

#: |EWMA log-ratio| above which a cell is considered drifted.  0.405 is
#: ln(1.5): flag when measurement disagrees with the model by ~1.5x in
#: either direction, comfortably past run-to-run timer noise.
DEFAULT_THRESHOLD = math.log(1.5)

#: EWMA smoothing (~the last 10 samples)
EWMA_ALPHA = 0.2

CORRUPT_SUFFIX = ".corrupt"

#: paths already warned about this process (corrupt and unwritable alike)
_WARNED_PATHS: set = set()


def _warn_once(path: str, msg: str) -> None:
    if path in _WARNED_PATHS:
        return
    _WARNED_PATHS.add(path)
    warnings.warn(msg, stacklevel=3)


@dataclass
class DriftCell:
    """EWMA residual state of one decision-table cell."""
    collective: str
    bucket: int                 # SIZE_BUCKETS index of the payload
    ewma_log_ratio: float = 0.0
    n: int = 0
    #: the last sample's concrete dispatch, for the report's provenance
    last_backend: str = ""
    last_wire: str = "float32"
    last_nbytes: int = 0

    def update(self, log_ratio: float, backend: str, wire: str,
               nbytes: int, alpha: float = EWMA_ALPHA) -> None:
        self.n += 1
        if self.n == 1:
            self.ewma_log_ratio = float(log_ratio)
        else:
            self.ewma_log_ratio += alpha * (float(log_ratio)
                                            - self.ewma_log_ratio)
        self.last_backend = backend
        self.last_wire = wire
        self.last_nbytes = int(nbytes)

    def key(self) -> str:
        return f"{self.collective}/b{self.bucket}"


@dataclass
class DriftSet:
    """All drift cells of one ``(device_kind, topology, p)`` store key."""
    device_kind: str
    topology: str
    p: int
    provenance: Dict[str, Optional[str]] = field(default_factory=dict)
    cells: Dict[str, DriftCell] = field(default_factory=dict)

    def key(self) -> str:
        return f"{_slug(self.device_kind)}__{_slug(self.topology)}__p{self.p}"

    def cell(self, collective: str, bucket: int) -> DriftCell:
        k = f"{collective}/b{bucket}"
        c = self.cells.get(k)
        if c is None:
            c = self.cells[k] = DriftCell(collective=collective,
                                          bucket=bucket)
        return c

    def to_json_dict(self) -> dict:
        return {
            "format": _FORMAT,
            "device_kind": self.device_kind,
            "topology": self.topology,
            "p": self.p,
            "provenance": dict(self.provenance),
            "cells": {
                k: {"collective": c.collective, "bucket": c.bucket,
                    "ewma_log_ratio": c.ewma_log_ratio, "n": c.n,
                    "last_backend": c.last_backend,
                    "last_wire": c.last_wire,
                    "last_nbytes": c.last_nbytes}
                for k, c in sorted(self.cells.items())
            },
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "DriftSet":
        if not isinstance(d, dict) or d.get("format") != _FORMAT:
            raise ValueError(
                f"unsupported drift format "
                f"{d.get('format') if isinstance(d, dict) else type(d)!r}")
        out = cls(device_kind=d["device_kind"], topology=d["topology"],
                  p=int(d["p"]), provenance=dict(d.get("provenance", {})))
        for k, c in d.get("cells", {}).items():
            out.cells[k] = DriftCell(
                collective=c["collective"], bucket=int(c["bucket"]),
                ewma_log_ratio=float(c.get("ewma_log_ratio", 0.0)),
                n=int(c.get("n", 0)),
                last_backend=c.get("last_backend", ""),
                last_wire=c.get("last_wire", "float32"),
                last_nbytes=int(c.get("last_nbytes", 0)))
        return out


# ---------------------------------------------------------------------------
# Residual accounting
# ---------------------------------------------------------------------------

def predicted_time(collective: str, backend: str, p: int, nbytes: int,
                   topology: str, wire_dtype: str = "float32"
                   ) -> Optional[float]:
    """Model time for one measured dispatch, or None where the cost
    engine has no entry (an unpriceable backend never drifts a cell)."""
    from repro_torch.topology.cost import predict_time
    from repro_torch.topology.presets import get_topology
    try:
        topo = get_topology(topology, p)
        return predict_time(collective, backend, p, float(nbytes), topo,
                            wire_dtype=wire_dtype)
    except (KeyError, ValueError):
        return None


def payload_bucket(nbytes: int) -> int:
    """Decision-table size-bucket index of a payload — the drift cell's
    key axis, shared with ``topology.table.DecisionTable.bucket_of``."""
    from repro_torch.topology.table import SIZE_BUCKETS
    import bisect
    return min(bisect.bisect_left(SIZE_BUCKETS, nbytes),
               len(SIZE_BUCKETS) - 1)


def bucket_bytes(bucket: int) -> int:
    """Representative payload (the inclusive upper edge) of one bucket —
    what ``--hints`` re-probes the cell at."""
    from repro_torch.topology.table import SIZE_BUCKETS
    return int(SIZE_BUCKETS[bucket])


def observe(dset: DriftSet, collective: str, backend: str, nbytes: int,
            measured_s: float, wire_dtype: str = "float32",
            alpha: float = EWMA_ALPHA) -> Optional[float]:
    """Fold one measured wall time into its drift cell.

    Returns the sample's log-ratio, or None when the model cannot price
    the dispatch or the measurement is degenerate (non-positive).
    """
    if measured_s <= 0.0:
        return None
    pred = predicted_time(collective, backend, dset.p, nbytes,
                          dset.topology, wire_dtype)
    if pred is None or pred <= 0.0:
        return None
    lr = math.log(measured_s / pred)
    dset.cell(collective, payload_bucket(nbytes)).update(
        lr, backend, wire_dtype, nbytes, alpha=alpha)
    return lr


def ingest_measurements(ms, topology: Optional[str] = None,
                        base: Optional[DriftSet] = None) -> DriftSet:
    """Fold a ``tuner.store.MeasurementSet`` into a drift set — probe
    measurements double as drift samples, so every ``launch/tune.py`` run
    refreshes the residuals for free.  ``base`` continues an existing
    set (the load-update-save cycle); otherwise a fresh one is built."""
    dset = base if base is not None else DriftSet(
        device_kind=ms.device_kind, topology=topology or ms.topology,
        p=ms.p, provenance=dict(ms.provenance))
    for m in ms.measurements:
        observe(dset, m.collective, m.backend, m.nbytes, m.time_s,
                wire_dtype=m.wire_dtype)
    return dset


@dataclass(frozen=True)
class RetuneHint:
    """One drifted cell: what to re-probe, and why."""
    collective: str
    p: int
    bucket: int
    nbytes: int                 # representative payload for the re-probe
    ewma_log_ratio: float
    n: int
    last_backend: str

    @property
    def ratio(self) -> float:
        """measured/predicted as a plain factor (e^EWMA)."""
        return math.exp(self.ewma_log_ratio)


def hints(dset: DriftSet,
          threshold: float = DEFAULT_THRESHOLD) -> List[RetuneHint]:
    """Cells whose |EWMA log-ratio| exceeds ``threshold``, worst first."""
    out = []
    for c in dset.cells.values():
        if c.n > 0 and abs(c.ewma_log_ratio) > threshold:
            out.append(RetuneHint(
                collective=c.collective, p=dset.p, bucket=c.bucket,
                nbytes=c.last_nbytes or bucket_bytes(c.bucket),
                ewma_log_ratio=c.ewma_log_ratio, n=c.n,
                last_backend=c.last_backend))
    return sorted(out, key=lambda h: -abs(h.ewma_log_ratio))


# ---------------------------------------------------------------------------
# Store (the tuner.store layout)
# ---------------------------------------------------------------------------

def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", s).strip("-") or "unknown"


def drift_dir() -> str:
    env = os.environ.get("REPRO_DRIFT_DIR")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-bine",
                        "drift")


def drift_path(dset: DriftSet, dir: Optional[str] = None) -> str:
    return os.path.join(dir or drift_dir(), dset.key() + ".json")


def save_drift(dset: DriftSet, dir: Optional[str] = None) -> Optional[str]:
    """Write (atomically) one drift set; returns the path, or None with
    one warning when the directory is unwritable (a read-only cache must
    degrade the monitoring, never kill the run that produced the data)."""
    path = drift_path(dset, dir)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dset.to_json_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except OSError as e:
        _warn_once(path, f"drift store {path} is unwritable ({e!r}); "
                         f"residuals from this run are NOT persisted")
        return None
    return path


def load_drift(device_kind: str, topology: str, p: int,
               dir: Optional[str] = None) -> Optional[DriftSet]:
    """One key's persisted drift set, or None — never raises.  Corrupt
    files are quarantined with one warning (the ``tuner.store`` contract)."""
    path = os.path.join(
        dir or drift_dir(),
        f"{_slug(device_kind)}__{_slug(topology)}__p{p}.json")
    try:
        with open(path) as f:
            return DriftSet.from_json_dict(json.load(f))
    except FileNotFoundError:
        return None
    except (OSError, ValueError, KeyError, TypeError,
            json.JSONDecodeError) as e:
        _warn_once(path, f"drift store file {path} is unreadable ({e!r}); "
                         f"quarantined to {path + CORRUPT_SUFFIX}")
        try:
            os.replace(path, path + CORRUPT_SUFFIX)
        except OSError:
            pass
        return None


def load_all_drift(topology: Optional[str] = None,
                   dir: Optional[str] = None,
                   device_kind: Optional[str] = None) -> List[DriftSet]:
    """Every persisted drift set (optionally filtered), file-name order."""
    d = dir or drift_dir()
    if not os.path.isdir(d):
        return []
    out = []
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, fname)) as f:
                dset = DriftSet.from_json_dict(json.load(f))
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError):
            continue
        if topology is not None and dset.topology != topology:
            continue
        if device_kind is not None and dset.device_kind != device_kind:
            continue
        out.append(dset)
    return out
