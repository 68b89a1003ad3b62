"""Run-wide observability: metrics registry, link-byte attribution,
predicted-vs-measured drift, and trace-timeline export.

The port of ``repro.obs``:

  * :mod:`repro_torch.obs.metrics`  — counters/gauges/quantile histograms;
  * :mod:`repro_torch.obs.collect`  — per-dispatch link-byte attribution;
  * :mod:`repro_torch.obs.drift`    — EWMA residuals + retune hints;
  * :mod:`repro_torch.obs.timeline` — Chrome-trace/Perfetto + Prometheus
    text.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    Registry,
    disabled,
    dump_registry,
    enabled,
    get_registry,
    scope,
    set_enabled,
)
from repro_torch.obs.timeline import (  # noqa: F401
    Timeline,
    dump_chrome_trace,
    export_prom,
    get_timeline,
    to_chrome_trace,
)
