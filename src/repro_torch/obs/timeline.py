"""Trace-timeline export (Chrome trace / Perfetto) + Prometheus text.

The port's copy of ``repro.obs.timeline``.  The runtime layers append events into a :class:`Timeline` — train steps
and fleet ticks as **spans**, chaos faults and replica drain/respawn as
**instants** — and :func:`to_chrome_trace` renders them in the Chrome
Trace Event format (``{"traceEvents": [...]}``, ``ph="X"`` complete
spans and ``ph="i"`` instants, microsecond timestamps), which loads
directly in ``ui.perfetto.dev`` or ``chrome://tracing``.

Two time bases coexist by design:

  * **train** events are wall-clock (``time.time()`` seconds at the call
    site, rendered as µs since the timeline's first event);
  * **fleet/serve** events use the fleet's *virtual integer tick clock*
    (1 tick = 1 µs in the trace) — deterministic replays produce
    byte-identical timelines, and chaos instants land exactly on the
    tick that armed them.

Each producer gets its own ``pid`` lane ("train", "fleet", …) so the two
clocks never share a track and the viewer shows them as separate
processes.

:func:`export_prom` renders a :class:`~repro_torch.obs.metrics.Registry` in
the Prometheus text exposition format (counters/gauges as samples,
histograms as ``_count``/``_sum`` + quantile gauges) for anyone who
wants to scrape a run artifact into existing dashboards.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.obs import metrics

#: pid lanes in the trace, one per producer clock
LANES = ("train", "fleet", "serve", "chaos", "bench")


@dataclass
class Event:
    """One timeline event; ``dur_us`` None means an instant (``ph="i"``)."""
    name: str
    lane: str                   # pid lane / which clock the ts is on
    ts_us: float
    dur_us: Optional[float] = None
    args: Dict = field(default_factory=dict)
    track: str = "0"            # tid within the lane (replica id, …)


class Timeline:
    """Append-only event log for one run."""

    def __init__(self):
        self.events: List[Event] = []

    def span(self, name: str, lane: str, ts_us: float, dur_us: float,
             track: str = "0", **args) -> None:
        if not metrics.enabled():
            return
        self.events.append(Event(name=name, lane=lane, ts_us=float(ts_us),
                                 dur_us=float(dur_us), track=str(track),
                                 args=dict(args)))

    def instant(self, name: str, lane: str, ts_us: float,
                track: str = "0", **args) -> None:
        if not metrics.enabled():
            return
        self.events.append(Event(name=name, lane=lane, ts_us=float(ts_us),
                                 track=str(track), args=dict(args)))

    def __len__(self) -> int:
        return len(self.events)

    def clear(self) -> None:
        self.events.clear()

    # -- serialization --------------------------------------------------------

    def to_json_dict(self) -> List[dict]:
        return [{"name": e.name, "lane": e.lane, "ts_us": e.ts_us,
                 "dur_us": e.dur_us, "track": e.track, "args": e.args}
                for e in self.events]

    @classmethod
    def from_json_dict(cls, rows: List[dict]) -> "Timeline":
        tl = cls()
        for r in rows:
            tl.events.append(Event(
                name=r["name"], lane=r["lane"], ts_us=float(r["ts_us"]),
                dur_us=None if r.get("dur_us") is None else float(r["dur_us"]),
                track=str(r.get("track", "0")), args=dict(r.get("args", {}))))
        return tl


def to_chrome_trace(tl: Timeline) -> dict:
    """Render as a Chrome Trace Event JSON object.

    Wall-clock lanes are rebased so the run's first event sits at ts=0
    (Perfetto dislikes epoch-scale microsecond offsets); virtual-tick
    lanes are already small integers and pass through unchanged.
    """
    # rebase each lane independently: lanes are separate clocks
    base: Dict[str, float] = {}
    for e in tl.events:
        if e.ts_us >= 1e12:  # epoch-scale wall clock
            base[e.lane] = min(base.get(e.lane, e.ts_us), e.ts_us)
    trace: List[dict] = []
    pids = {lane: i + 1 for i, lane in enumerate(LANES)}
    for e in tl.events:
        pid = pids.setdefault(e.lane, len(pids) + 1)
        row = {"name": e.name, "pid": pid, "tid": e.track,
               "ts": e.ts_us - base.get(e.lane, 0.0), "args": e.args}
        if e.dur_us is None:
            row["ph"] = "i"
            row["s"] = "p"      # process-scoped instant marker
        else:
            row["ph"] = "X"
            row["dur"] = e.dur_us
        trace.append(row)
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": lane}} for lane, pid in sorted(
                 pids.items(), key=lambda kv: kv[1])]
    return {"traceEvents": meta + trace, "displayTimeUnit": "ms"}


def dump_chrome_trace(tl: Timeline, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tl), f, indent=1, sort_keys=True)
        f.write("\n")


#: the default timeline the instrumented layers append to
_TIMELINE = Timeline()


def get_timeline() -> Timeline:
    return _TIMELINE


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _prom_num(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def export_prom(reg: Optional[metrics.Registry] = None) -> str:
    """Prometheus text exposition of a registry (default: the process
    registry).  Counters render with the ``_total`` suffix convention;
    histograms as ``_count``/``_sum`` plus p50/p99 quantile samples."""
    reg = reg or metrics.get_registry()
    lines: List[str] = []
    seen_types = set()

    def typeline(name: str, kind: str):
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for (name, lk), v in sorted(reg.counters.items()):
        typeline(f"{name}_total", "counter")
        lines.append(f"{name}_total{_prom_labels(dict(lk))} {_prom_num(v)}")
    for (name, lk), v in sorted(reg.gauges.items()):
        typeline(name, "gauge")
        lines.append(f"{name}{_prom_labels(dict(lk))} {_prom_num(v)}")
    for (name, lk), h in sorted(reg.histograms.items()):
        typeline(name, "summary")
        labels = dict(lk)
        for q in (0.5, 0.99):
            qlabels = dict(labels, quantile=str(q))
            lines.append(f"{name}{_prom_labels(qlabels)} "
                         f"{_prom_num(h.quantile(q * 100.0))}")
        lines.append(f"{name}_count{_prom_labels(labels)} {h.count}")
        lines.append(f"{name}_sum{_prom_labels(labels)} {_prom_num(h.total)}")
    return "\n".join(lines) + ("\n" if lines else "")
