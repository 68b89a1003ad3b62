"""Process-local metrics registry: counters, gauges, quantile histograms.

The port's copy of ``repro.obs.metrics``; the same calls give the same
snapshot in both packages.  Zero dependencies beyond the stdlib, no background threads, no sockets —
the registry is a plain in-process accumulator the runtime layers write
into and the report/export paths read out of.  Three instrument kinds:

  * **counter** — monotonically accumulated float (``inc``);
  * **gauge**   — last-write-wins float (``set_gauge``);
  * **histogram** — raw observations, summarized by *nearest-rank*
    quantiles (the ``serve.scheduler._pct`` convention: deterministic,
    no interpolation) so registry percentiles agree digit-for-digit with
    the scheduler's own latency summaries.

Every sample carries a label set.  Labels come from the call site plus
whatever :func:`scope` frames are active::

    with REGISTRY.scope(replica="0"):
        REGISTRY.inc("fleet_ticks")           # labeled {replica="0"}

Series identity is ``(name, sorted labels)`` — the Prometheus data-model
convention — so ``export_prom`` (``obs.timeline``) can render the
registry losslessly.

The module-level default registry (:func:`get_registry`) is what the
instrumented layers (``collectives.api``, ``train.step``,
``train.runtime``, ``serve.scheduler``) write to; :func:`enabled` /
:func:`set_enabled` gate all of them at once (env ``REPRO_OBS=0`` starts a
process disabled), which is how ``chip_smoke.py`` measures the API hook's
own host cost.
"""

from __future__ import annotations

import json
import math
import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

#: a series key: (metric name, ((label, value), ...) sorted by label)
SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _nearest_rank(xs: List[float], q: float) -> float:
    """Nearest-rank percentile of ``xs`` at ``q`` in [0, 100] — identical
    to ``serve.scheduler._pct`` (duplicated so obs stays import-light)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = max(0, min(len(xs) - 1, int(math.ceil(q / 100.0 * len(xs))) - 1))
    return float(xs[k])


def _labels_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclass
class Histogram:
    """Raw-sample histogram with nearest-rank quantiles.

    Samples are kept verbatim (runs here are bounded — fleet ticks, train
    steps, probe cells), so any quantile is exact; ``summary`` renders
    the fixed p50/p99 pair every latency report in this repo uses.
    """
    samples: List[float] = field(default_factory=list)

    def observe(self, x: float) -> None:
        self.samples.append(float(x))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def total(self) -> float:
        return float(sum(self.samples))

    def quantile(self, q: float) -> float:
        return _nearest_rank(self.samples, q)

    def summary(self) -> Dict[str, float]:
        return {"count": float(self.count), "sum": self.total,
                "p50": self.quantile(50.0), "p99": self.quantile(99.0)}


class Registry:
    """One process-local metrics store (counters + gauges + histograms)."""

    def __init__(self):
        self.counters: Dict[SeriesKey, float] = {}
        self.gauges: Dict[SeriesKey, float] = {}
        self.histograms: Dict[SeriesKey, Histogram] = {}
        self._scope_stack: List[Dict[str, str]] = []

    # -- labels --------------------------------------------------------------

    @contextmanager
    def scope(self, **labels) -> Iterator[None]:
        """Label frame: every sample recorded inside carries ``labels``
        (inner frames and call-site labels win on key collisions)."""
        self._scope_stack.append({str(k): str(v) for k, v in labels.items()})
        try:
            yield
        finally:
            self._scope_stack.pop()

    def _key(self, name: str, labels: Dict) -> SeriesKey:
        merged: Dict[str, str] = {}
        for frame in self._scope_stack:
            merged.update(frame)
        merged.update({str(k): str(v) for k, v in labels.items()})
        return (name, _labels_key(merged))

    # -- instruments ---------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels) -> float:
        """Add ``value`` to a counter; returns the new total."""
        key = self._key(name, labels)
        self.counters[key] = self.counters.get(key, 0.0) + float(value)
        return self.counters[key]

    def inc_series(self, lk: Tuple[Tuple[str, str], ...],
                   items: Tuple[Tuple[str, float], ...]) -> None:
        """``inc`` of several counters that share the call-site labels,
        given as their sorted key (``_labels_key``) so a caller can build
        it once; active ``scope`` frames still apply."""
        if self._scope_stack:
            for name, value in items:
                self.inc(name, value, **dict(lk))
            return
        for name, value in items:
            key = (name, lk)
            self.counters[key] = self.counters.get(key, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self.gauges[self._key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one histogram sample."""
        key = self._key(name, labels)
        hist = self.histograms.get(key)
        if hist is None:
            hist = self.histograms[key] = Histogram()
        hist.observe(value)

    # -- reads ---------------------------------------------------------------

    def counter_value(self, name: str, **labels) -> float:
        return self.counters.get(self._key(name, labels), 0.0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        return self.gauges.get(self._key(name, labels))

    def quantile(self, name: str, q: float, **labels) -> float:
        hist = self.histograms.get(self._key(name, labels))
        return hist.quantile(q) if hist is not None else 0.0

    def series(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        """Every (labels, value) of one counter/gauge name, sorted by
        label set — the report CLI's aggregation input."""
        out = []
        for store in (self.counters, self.gauges):
            for (n, lk), v in store.items():
                if n == name:
                    out.append((dict(lk), v))
        return sorted(out, key=lambda t: sorted(t[0].items()))

    # -- lifecycle / serialization -------------------------------------------

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()

    def snapshot(self) -> dict:
        """JSON-able dump: the run-artifact payload ``launch/report.py``
        renders.  Histograms serialize as summaries plus raw samples, so
        a loaded snapshot can still answer any quantile."""
        def rows(store):
            return [{"name": n, "labels": dict(lk), "value": v}
                    for (n, lk), v in sorted(store.items())]
        return {
            "counters": rows(self.counters),
            "gauges": rows(self.gauges),
            "histograms": [
                {"name": n, "labels": dict(lk), **h.summary(),
                 "samples": list(h.samples)}
                for (n, lk), h in sorted(self.histograms.items())
            ],
        }

    @classmethod
    def from_snapshot(cls, d: dict) -> "Registry":
        reg = cls()
        for row in d.get("counters", ()):
            reg.counters[(row["name"], _labels_key(row["labels"]))] = \
                float(row["value"])
        for row in d.get("gauges", ()):
            reg.gauges[(row["name"], _labels_key(row["labels"]))] = \
                float(row["value"])
        for row in d.get("histograms", ()):
            hist = Histogram(samples=[float(x) for x in row["samples"]])
            reg.histograms[(row["name"], _labels_key(row["labels"]))] = hist
        return reg


#: the default registry every instrumented layer writes to
_REGISTRY = Registry()

#: master switch; env REPRO_OBS=0 starts the process disabled
_ENABLED = os.environ.get("REPRO_OBS", "1") not in ("0", "false", "off")


def get_registry() -> Registry:
    return _REGISTRY


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Flip the instrumentation master switch; returns the previous
    state (so benchmark A/B runs can restore it)."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    return prev


@contextmanager
def disabled() -> Iterator[None]:
    """Temporarily switch instrumentation off (the benchmark's obs-off
    arm and tests that must not pollute the default registry)."""
    prev = set_enabled(False)
    try:
        yield
    finally:
        set_enabled(prev)


def scope(**labels):
    """``get_registry().scope(...)`` — the label mechanism, module-level."""
    return _REGISTRY.scope(**labels)


def dump_registry(path: str, timestamp: Optional[str] = None) -> None:
    """Write the default registry's snapshot as JSON (timestamp recorded
    verbatim — the repo-wide caller-supplies-the-clock convention)."""
    with open(path, "w") as f:
        json.dump({"format": 1, "timestamp": timestamp,
                   "registry": _REGISTRY.snapshot()}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
