"""Telemetry of the exploration stack, a port of ``repro.obs``.

Everything here is host-side Python (dicts, floats, file appends), never a
device kernel, so trajectories are the same with telemetry on or off.

- ``metrics``  :class:`MetricsRegistry` (counters, gauges, histograms,
               collectors) and :func:`render_prometheus`; snapshots and
               their Prometheus text are byte for byte the reference's.
- ``events``   :class:`EventLog`, the append-only JSON-lines log with
               crash-safe generations, and :func:`read_events`.
- ``progress`` :func:`log_progress`, the per-round helper every driver
               calls (history record, verbose line, event).
- ``trace``    :func:`build_chrome_trace` / :func:`summarize_events`.

The formats are the reference's: either package reads and renders the
other's event logs.
"""
from .events import EventLog, read_events
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      render_prometheus)
from .progress import log_progress
from .trace import build_chrome_trace, summarize_events

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "render_prometheus",
    "EventLog", "read_events",
    "log_progress",
    "build_chrome_trace", "summarize_events",
]
