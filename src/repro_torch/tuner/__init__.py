"""The tuner's schedule-replay link tracer (``tuner.trace``), which
``obs.collect`` attributes link bytes with.  The probe, the measurement
store and the table refresh of ``repro.tuner`` are ROADMAP.md queue A
item 6; ``topology.table`` reads the measured tables they write."""

from .trace import (TraceResult, replayed_reduction, trace_collective,
                    trace_schedule)

__all__ = ["TraceResult", "replayed_reduction", "trace_collective",
           "trace_schedule"]
