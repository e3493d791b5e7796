"""repro_torch.obs — tracing, flight recorder, and telemetry for the port
(a copy of ``repro/obs``: pure stdlib, the same API and the same record,
Chrome-trace, JSONL and Prometheus formats).

Three pieces:

* ``repro_torch.obs.trace`` — span/event API over a bounded ring-buffer flight
  recorder.  Off by default; ``enable()`` to record.
* ``repro_torch.obs.registry`` — the unified :class:`TelemetryRegistry` that
  absorbs the dispatch, kernel-route, kernel-launch, engine and
  program-build counter stores.
* ``repro_torch.obs.export`` — Chrome/Perfetto, JSONL, and Prometheus
  exporters plus schema validation and the phase-breakdown summary.

``python -m repro_torch.obs`` summarizes, converts, or validates a recorded
trace file.
"""

from repro_torch.obs.trace import (  # noqa: F401
    enable, disable, enabled, span, event, complete,
    records, clear, dropped, dump, postmortem,
)
from repro_torch.obs.registry import (  # noqa: F401
    REGISTRY, TelemetryRegistry, snapshot_diff,
)
from repro_torch.obs.export import (  # noqa: F401
    to_chrome_trace, to_jsonl, prometheus_text,
    phase_breakdown, validate_chrome_trace,
)

__all__ = [
    "enable", "disable", "enabled", "span", "event", "complete",
    "records", "clear", "dropped", "dump", "postmortem",
    "REGISTRY", "TelemetryRegistry", "snapshot_diff",
    "to_chrome_trace", "to_jsonl", "prometheus_text",
    "phase_breakdown", "validate_chrome_trace",
]
