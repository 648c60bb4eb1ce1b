"""Chrome trace-event export: the run timeline as Perfetto loads it.

One telemetry track == one named thread row (``ph: "M"``/``thread_name``
metadata). Events with ``dur`` become complete slices (``ph: "X"``);
events without become instants (``ph: "i"``). All timestamps are the
run's monotonic seconds scaled to microseconds, so the Perfetto ruler
reads as time-since-run-start.

Format reference: the Trace Event Format JSON accepted by
``ui.perfetto.dev`` and ``chrome://tracing`` — an object with a
``traceEvents`` list.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List

__all__ = ["to_chrome_trace", "export_chrome_trace", "trace_track_names"]

_PID = 0  # single-process timeline; tracks are threads under it


def to_chrome_trace(events: Iterable[dict]) -> dict:
    """Render schema events as a Chrome trace-event JSON object."""
    events = list(events)
    # Stable track -> tid mapping in first-appearance order.
    tids: Dict[str, int] = {}
    for ev in events:
        track = ev.get("track", "run")
        if track not in tids:
            tids[track] = len(tids)

    out: List[dict] = [{
        "ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
        "args": {"name": "repro-dfl run"},
    }]
    for track, tid in tids.items():
        out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                    "tid": tid, "args": {"name": track}})

    for ev in events:
        rec = {
            "pid": _PID,
            "tid": tids[ev.get("track", "run")],
            "ts": float(ev.get("t", 0.0)) * 1e6,
            "name": ev.get("name") or ev.get("type", "event"),
            "cat": ev.get("type", "event"),
            "args": ev.get("data", {}),
        }
        if ev.get("dur") is not None:
            rec["ph"] = "X"
            rec["dur"] = float(ev["dur"]) * 1e6
        else:
            rec["ph"] = "i"
            rec["s"] = "t"  # thread-scoped instant
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def trace_track_names(trace: dict) -> List[str]:
    """Named tracks in an exported trace (the thread_name metadata)."""
    return [m["args"]["name"] for m in trace.get("traceEvents", [])
            if m.get("ph") == "M" and m.get("name") == "thread_name"]


def export_chrome_trace(events: Iterable[dict], path: str) -> dict:
    trace = to_chrome_trace(events)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace
