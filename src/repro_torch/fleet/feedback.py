"""Measured per-replica tick-latency feedback for fleet routing.

Port of ``repro.fleet.feedback``, in the reference's file format and at
its paths, so a feedback file written by either package loads in the
other.  The ``repro_torch.tuner.store`` pattern one level up: one JSON file per
``(device_kind, topology, p)`` with provenance metadata, so a routing
decision can always be traced back to the run that measured it.  The
fleet loop records every replica tick's wall latency into an EWMA (plus a
tick-latency log for percentiles); the router consumes the live EWMAs for
least-loaded spill, and a persisted set warm-starts the next run's
routing before it has measured anything.

Layout (``REPRO_FLEET_FEEDBACK_DIR`` overrides, default
``~/.cache/repro-bine/fleet``)::

    <dir>/<device_kind>__<topology>__p<p>.json

File format::

    {
      "format": 1,
      "device_kind": "cpu", "topology": "lumi", "p": 8,
      "provenance": {"timestamp": null, "source": "repro.fleet"},
      "replicas": {
        "0": {"ticks": 128, "ewma_tick_s": 1.9e-3,
              "p50_tick_s": 1.7e-3, "p99_tick_s": 4.2e-3}, ...
      }
    }

Timestamps are caller-supplied strings recorded verbatim (the repo-wide
convention: tools never invent their own clock, so reruns stay diffable).
"""

from __future__ import annotations

import json
import os
import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_FORMAT = 1

#: suffix a quarantined (unparseable) feedback file is renamed to — the
#: ``tuner.store`` convention, duplicated rather than imported (the fleet
#: does not depend on the tuner package)
CORRUPT_SUFFIX = ".corrupt"

#: paths already warned about this process
_WARNED_PATHS: set = set()


def _quarantine_once(path: str, err: BaseException) -> None:
    """Move an unparseable feedback file aside and warn once per path:
    the next fleet run starts cold instead of re-tripping on it."""
    if path not in _WARNED_PATHS:
        _WARNED_PATHS.add(path)
        warnings.warn(
            f"fleet feedback file {path} is unreadable ({err!r}); "
            f"quarantined to {path + CORRUPT_SUFFIX} — routing starts "
            f"cold and the next save rewrites it",
            stacklevel=3)
    try:
        os.replace(path, path + CORRUPT_SUFFIX)
    except OSError:
        pass  # read-only dir: the load already skipped the file

#: default EWMA smoothing: ~last 10 ticks dominate
EWMA_ALPHA = 0.2


@dataclass
class Ewma:
    """Exponentially-weighted moving average of tick latencies."""
    alpha: float = EWMA_ALPHA
    value: float = 0.0
    count: int = 0

    def update(self, x: float) -> float:
        self.count += 1
        if self.count == 1:
            self.value = float(x)
        else:
            self.value += self.alpha * (float(x) - self.value)
        return self.value


@dataclass
class ReplicaStats:
    """One replica's measured tick-latency summary."""
    ticks: int = 0
    ewma_tick_s: float = 0.0
    p50_tick_s: float = 0.0
    p99_tick_s: float = 0.0


@dataclass
class FleetFeedback:
    """All replica latency summaries of one fleet run at one key."""
    device_kind: str
    topology: str
    p: int
    provenance: Dict[str, Optional[str]] = field(default_factory=dict)
    replicas: Dict[str, ReplicaStats] = field(default_factory=dict)
    #: the run's *request*-level ``serve.scheduler.latency_summary``
    #: (p50/p99 of ttft/e2e/..., not just the routing EWMA) so the report
    #: CLI and warm starts see tail latency.  Optional: format-1 files
    #: written before this field simply load with an empty dict.
    latency: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def key(self) -> str:
        return f"{_slug(self.device_kind)}__{_slug(self.topology)}__p{self.p}"

    def warm_start(self) -> Dict[int, float]:
        """replica id -> prior EWMA tick latency (seconds), the router's
        pre-measurement load weights."""
        return {int(r): s.ewma_tick_s for r, s in self.replicas.items()
                if s.ticks > 0}

    def to_json_dict(self) -> dict:
        out = {
            "format": _FORMAT,
            "device_kind": self.device_kind,
            "topology": self.topology,
            "p": self.p,
            "provenance": dict(self.provenance),
            "replicas": {
                r: {"ticks": s.ticks, "ewma_tick_s": s.ewma_tick_s,
                    "p50_tick_s": s.p50_tick_s, "p99_tick_s": s.p99_tick_s}
                for r, s in self.replicas.items()
            },
        }
        if self.latency:
            out["latency"] = {k: dict(v) for k, v in self.latency.items()}
        return out

    @classmethod
    def from_json_dict(cls, d: dict) -> "FleetFeedback":
        if d.get("format") != _FORMAT:
            raise ValueError(
                f"unsupported fleet feedback format {d.get('format')!r}")
        return cls(
            device_kind=d["device_kind"],
            topology=d["topology"],
            p=int(d["p"]),
            provenance=dict(d.get("provenance", {})),
            replicas={
                str(r): ReplicaStats(
                    ticks=int(s.get("ticks", 0)),
                    ewma_tick_s=float(s.get("ewma_tick_s", 0.0)),
                    p50_tick_s=float(s.get("p50_tick_s", 0.0)),
                    p99_tick_s=float(s.get("p99_tick_s", 0.0)))
                for r, s in d.get("replicas", {}).items()
            },
            # absent in files written before the latency field existed
            latency={str(k): {str(m): float(x) for m, x in v.items()}
                     for k, v in d.get("latency", {}).items()},
        )


def replica_stats(ticks: List[float], ewma: Ewma) -> ReplicaStats:
    """Summarize one replica's tick-latency log (nearest-rank
    percentiles, matching ``serve.scheduler.latency_summary``)."""
    from repro_torch.serve.scheduler import _pct
    return ReplicaStats(ticks=len(ticks), ewma_tick_s=ewma.value,
                        p50_tick_s=_pct(ticks, 50.0),
                        p99_tick_s=_pct(ticks, 99.0))


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", s).strip("-") or "unknown"


def feedback_dir() -> str:
    env = os.environ.get("REPRO_FLEET_FEEDBACK_DIR")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-bine",
                        "fleet")


def feedback_path(fb: FleetFeedback, dir: Optional[str] = None) -> str:
    return os.path.join(dir or feedback_dir(), fb.key() + ".json")


def save_feedback(fb: FleetFeedback,
                  dir: Optional[str] = None) -> Optional[str]:
    """Write (atomically) one feedback set; returns the path, or None
    with one warning per path when the directory is unwritable — a
    read-only cache dir must not kill the run that measured the data."""
    path = feedback_path(fb, dir)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(fb.to_json_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except OSError as e:
        if path not in _WARNED_PATHS:
            _WARNED_PATHS.add(path)
            warnings.warn(
                f"fleet feedback dir for {path} is unwritable ({e!r}); "
                f"this run's measured latency is NOT persisted",
                stacklevel=3)
        return None
    return path


def load_feedback(device_kind: str, topology: str, p: int,
                  dir: Optional[str] = None) -> Optional[FleetFeedback]:
    """The persisted set for one key, or None (missing/corrupt files
    never poison a run — routing just starts cold).  A corrupt file is
    additionally quarantined (renamed ``.corrupt``) with one warning per
    path per process, matching ``tuner.store``."""
    fb = FleetFeedback(device_kind=device_kind, topology=topology, p=p)
    path = feedback_path(fb, dir)
    try:
        with open(path) as f:
            return FleetFeedback.from_json_dict(json.load(f))
    except FileNotFoundError:
        return None
    except (OSError, ValueError, KeyError, TypeError,
            json.JSONDecodeError) as e:
        _quarantine_once(path, e)
        return None
