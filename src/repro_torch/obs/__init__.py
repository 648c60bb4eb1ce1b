"""repro_torch.obs — the port's telemetry: a copy of ``repro.obs``.

The same schema (``SCHEMA_VERSION``, ``EVENT_TYPES``, ``REQUIRED_DATA``), so
a stream written by either package validates and reports in both; stdlib
only, like the reference's.

Three pillars (the reference's docs/ARCHITECTURE.md "Observability"):

1. **Event stream** (``events``, ``telemetry``): a ``Telemetry`` sink
   collects typed, timestamped events as append-only JSONL;
   ``RoundExecutor``/``MetricsBuffer``/``HostPrefetcher``,
   ``AdaptiveController`` and ``launch/train.py`` of the port emit into it, and the
   ``--history-out`` JSON is a schema-versioned view over the stream
   (``history.history_view``).
2. **Span tracing** (``telemetry.span``, ``trace``): host-side spans on
   monotonic ``perf_counter`` clocks, exported as Chrome trace-event /
   Perfetto-loadable JSON — one track per concern.
3. **Counter attribution** (``report``): kernel ``op_stats`` deltas,
   build and capture counts, wire-bit totals and prefetch hit/stale
   snapshots attributed to their superstep; ``python -m repro_torch.obs
   report`` prints
   the per-phase cost breakdown.

Contract: telemetry adds ZERO host syncs, ZERO builds and ZERO graph
captures on the round path. Events are host-side appends around the
executor's replays, and no event reads a device tensor (metric values
reach events only through a ``MetricsBuffer`` flush), so a dispatch with
a sink is bitwise the same dispatch without one. This package imports
neither torch nor anything of the reference.

CLI::

    python -m repro_torch.obs validate events.jsonl [--min-tracks N]
    python -m repro_torch.obs trace export events.jsonl --out trace.json
    python -m repro_torch.obs report events.jsonl
"""
from repro_torch.obs.events import (EVENT_TYPES, KNOWN_SCHEMAS, REQUIRED_DATA,
                              SCHEMA_VERSION, make_event, read_events,
                              validate_event, validate_events,
                              validate_stream, write_events)
from repro_torch.obs.history import HISTORY_SCHEMA_VERSION, history_view
from repro_torch.obs.report import format_report, run_report
from repro_torch.obs.telemetry import NullTelemetry, Telemetry
from repro_torch.obs.trace import (export_chrome_trace, to_chrome_trace,
                             trace_track_names)

__all__ = [
    "EVENT_TYPES",
    "REQUIRED_DATA",
    "SCHEMA_VERSION",
    "KNOWN_SCHEMAS",
    "HISTORY_SCHEMA_VERSION",
    "Telemetry",
    "NullTelemetry",
    "make_event",
    "read_events",
    "write_events",
    "validate_event",
    "validate_events",
    "validate_stream",
    "history_view",
    "run_report",
    "format_report",
    "to_chrome_trace",
    "export_chrome_trace",
    "trace_track_names",
]
