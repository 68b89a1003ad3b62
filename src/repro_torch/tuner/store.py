"""On-disk measurement cache for the empirical autotuner.

Port of ``repro.tuner.store``, file for file: the same layout, format and
environment variable, so a store written by either package loads in the
other.  One JSON file per (device_kind, topology, p) — the key under
which ``refresh`` rebuilds decision-table cells — with provenance
metadata (library versions, grid name, caller-supplied timestamp) so a
measured table can always be traced back to the run that produced it.

Layout (``REPRO_MEASURE_DIR`` overrides, default
``~/.cache/repro-bine/measurements``)::

    <dir>/<device_kind>__<topology>__p<p>.json

File format::

    {
      "format": 1,
      "device_kind": "NVIDIA H100 80GB HBM3", "topology": "lumi", "p": 4,
      "provenance": {"grid": "small", "timestamp": null, "torch": "2.5.1",
                     "cuda": "12.4", "platform": "gpu"},
      "measurements": [
        {"collective": "allreduce", "backend": "bine", "p": 4,
         "nbytes": 65536, "time_s": 1.2e-4, "reps": 10,
         "wire_dtype": "float32"}, ...
      ]
    }

The port's probe records ``torch``, ``cuda`` and ``platform`` ("gpu" or
"cpu") where the reference's records ``jax``; provenance is free-form, so
either package reads the other's.  Timestamps are caller-supplied strings
recorded verbatim: tools never invent their own clock, so reruns stay
diffable.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

_FORMAT = 1

#: suffix a quarantined (unparseable) store file is renamed to
CORRUPT_SUFFIX = ".corrupt"

#: paths already warned about this process (see ``_warn_corrupt_once``)
_WARNED_PATHS: set = set()


def _warn_corrupt_once(path: str, err: BaseException) -> None:
    """One warning per corrupt file per process — a tune run that loads
    the store dozens of times must not repeat itself."""
    if path in _WARNED_PATHS:
        return
    _WARNED_PATHS.add(path)
    warnings.warn(
        f"measurement store file {path} is unreadable ({err!r}); "
        f"quarantined to {path + CORRUPT_SUFFIX} — the remaining store "
        f"files stay valid, re-run the probe to replace it",
        stacklevel=3)


def quarantine(path: str) -> Optional[str]:
    """Move an unparseable store file aside (``<path>.corrupt``) so the
    next run does not trip over it again; returns the new path, or None
    when the rename itself failed (read-only dir — the load still just
    skips the file)."""
    target = path + CORRUPT_SUFFIX
    try:
        os.replace(path, target)
    except OSError:
        return None
    return target


@dataclass(frozen=True)
class Measurement:
    """One timed collective invocation (trimmed-median over reps).

    ``nbytes`` stays the FULL-vector float32 payload whatever the wire
    dtype — the decision-table key convention; the codec's byte saving is
    a property of the timed program, not of the key.
    """
    collective: str
    backend: str
    p: int
    nbytes: int        # FULL-vector payload, the decision-table convention
    time_s: float
    reps: int = 0
    wire_dtype: str = "float32"


@dataclass
class MeasurementSet:
    """All measurements of one probe run at one (device_kind, topology, p)."""
    device_kind: str
    topology: str
    p: int
    provenance: Dict[str, Optional[str]] = field(default_factory=dict)
    measurements: List[Measurement] = field(default_factory=list)

    def key(self) -> str:
        return f"{_slug(self.device_kind)}__{_slug(self.topology)}__p{self.p}"

    def to_json_dict(self) -> dict:
        return {
            "format": _FORMAT,
            "device_kind": self.device_kind,
            "topology": self.topology,
            "p": self.p,
            "provenance": dict(self.provenance),
            "measurements": [asdict(m) for m in self.measurements],
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "MeasurementSet":
        if not isinstance(d, dict):
            raise ValueError(
                f"measurement file holds a {type(d).__name__}, not an "
                f"object")
        if d.get("format") != _FORMAT:
            raise ValueError(
                f"unsupported measurement format {d.get('format')!r}")
        if not isinstance(d.get("measurements"), list):
            raise ValueError("'measurements' must be a list")
        return cls(
            device_kind=d["device_kind"],
            topology=d["topology"],
            p=int(d["p"]),
            provenance=dict(d.get("provenance", {})),
            measurements=[Measurement(
                collective=m["collective"], backend=m["backend"],
                p=int(m["p"]), nbytes=int(m["nbytes"]),
                time_s=float(m["time_s"]), reps=int(m.get("reps", 0)),
                wire_dtype=m.get("wire_dtype", "float32"))
                for m in d["measurements"]],
        )


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", s).strip("-") or "unknown"


def store_dir() -> str:
    env = os.environ.get("REPRO_MEASURE_DIR")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-bine",
                        "measurements")


def measurement_path(ms: MeasurementSet, dir: Optional[str] = None) -> str:
    return os.path.join(dir or store_dir(), ms.key() + ".json")


def save_measurements(ms: MeasurementSet,
                      dir: Optional[str] = None) -> Optional[str]:
    """Write (atomically) one measurement set; returns the path.

    An unwritable directory (read-only cache, squashed home) returns
    ``None`` with one warning per path naming it — the probe run that
    produced the measurements must not die on the persistence step, and
    silence would hide that the tuner is re-measuring every run."""
    path = measurement_path(ms, dir)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(ms.to_json_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except OSError as e:
        if path not in _WARNED_PATHS:
            _WARNED_PATHS.add(path)
            warnings.warn(
                f"measurement store dir for {path} is unwritable ({e!r}); "
                f"this run's probe measurements are NOT persisted",
                stacklevel=3)
        return None
    return path


def load_measurements(path: str) -> Optional[MeasurementSet]:
    """One store file, or ``None`` — never raises for a bad file.

    A missing file is simply ``None`` (cold caches never poison a run).
    An *unparseable* file — torn write, hand-edit — is quarantined
    (renamed ``<path>.corrupt``) with one warning per path per process,
    so the next run does not re-trip on it and the rest of the store
    stays usable.
    """
    try:
        with open(path) as f:
            d = json.load(f)
        return MeasurementSet.from_json_dict(d)
    except FileNotFoundError:
        return None
    except (OSError, ValueError, KeyError, TypeError,
            json.JSONDecodeError) as e:
        _warn_corrupt_once(path, e)
        quarantine(path)
        return None


def load_all_measurements(topology: Optional[str] = None,
                          dir: Optional[str] = None,
                          device_kind: Optional[str] = None
                          ) -> List[MeasurementSet]:
    """Every cached set (optionally filtered), sorted by file name so the
    refresh input order — and therefore the rebuilt table — is
    deterministic.  Corrupt files are quarantined by
    :func:`load_measurements` and skipped — they never poison a refresh."""
    d = dir or store_dir()
    if not os.path.isdir(d):
        return []
    out = []
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".json"):
            continue
        ms = load_measurements(os.path.join(d, fname))
        if ms is None:
            continue
        if topology is not None and ms.topology != topology:
            continue
        if device_kind is not None and ms.device_kind != device_kind:
            continue
        out.append(ms)
    return out
