"""The telemetry event schema: typed, timestamped, append-only JSONL.

One run = one stream of event records. Every record is a flat JSON
object:

``type``   (required) one of ``EVENT_TYPES`` — the event's kind.
``t``      (required) seconds since the run's monotonic origin
           (``time.perf_counter`` based — NEVER wall clock, so a
           wall-clock jump can't corrupt durations).
``track``  (required) the concern this event belongs to (one timeline
           row in the trace export): ``dispatch``, ``prefetch``,
           ``metrics``, ``planner``, ``checkpoint``, ``rounds``,
           ``run``, or any caller-chosen string.
``name``   (optional) human label; spans REQUIRE it.
``dur``    (optional) span duration in seconds; events with ``dur``
           render as slices, events without as instants.
``data``   (optional) dict of JSON scalars/lists — the typed payload;
           ``REQUIRED_DATA`` lists the per-type mandatory keys.

The stream's first record is the ``run`` header, whose data carries
``schema`` (= ``SCHEMA_VERSION``) and ``wall_start`` (the ONE absolute
unix timestamp — every other time in the stream is monotonic-relative).
Events are appended in emission order; because background threads
(``HostPrefetcher``) emit spans stamped at their *start* time, ``t`` is
NOT required to be monotone across records.

This module is intentionally stdlib-only: readers
(validators, CI, the report CLI) must work on boxes where the library
itself may not import.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "SCHEMA_VERSION",
    "KNOWN_SCHEMAS",
    "EVENT_TYPES",
    "REQUIRED_DATA",
    "make_event",
    "validate_event",
    "validate_events",
    "validate_stream",
    "read_events",
    "write_events",
]

# Schema 2 adds the fault-tolerance vocabulary: ``fault`` (an injected
# fault window opening/closing) and ``degraded`` (a round that ran with
# masked nodes/edges — realized participation attached). Schema 3 adds
# ``overlap`` (a pipelined superstep's in-flight gossip slice — rendered
# on its own track so the trace shows the wire riding under compute).
# Older streams stay readable: the new types are additive and every
# schema-1/2 record is schema-3 valid.
SCHEMA_VERSION = 3
KNOWN_SCHEMAS = frozenset({1, 2, 3})

# The typed vocabulary. Each type is a kind of thing that happens in a
# run; anything else is a schema violation (add the type HERE, with its
# required payload, before emitting it).
EVENT_TYPES = frozenset({
    "run",         # stream header: schema version + wall-clock anchor
    "round",       # one completed DFL round (realized schedule + metrics)
    "superstep",   # one fused K-round dispatch (the executor hot path)
    "plan",        # an initial/trajectory schedule decision
    "replan",      # a boundary re-plan that may change the schedule
    "probe",       # an identifiability probe round injection
    "compile",     # a build of the round, or a capture of its graphs
    "checkpoint",  # a checkpoint write
    "prefetch",    # host batch prefetch activity (build/cancel/stale)
    "flush",       # a MetricsBuffer host-sync flush
    "span",        # a generic named timed region (with telemetry.span)
    "counters",    # a counter snapshot attributed to its superstep
    "fault",       # an injected fault window opening or closing (schema 2)
    "degraded",    # a round run with masked nodes/edges (schema 2)
    "overlap",     # a pipelined superstep's in-flight gossip slice (schema 3)
})

# Per-type mandatory ``data`` keys (beyond the top-level type/t/track).
REQUIRED_DATA: Dict[str, Tuple[str, ...]] = {
    "run": ("schema", "wall_start"),
    "round": ("round", "tau1", "tau2", "round_s"),
    "superstep": ("k",),
    "plan": ("tau1", "tau2"),
    "replan": ("tau1", "tau2"),
    "probe": ("tau1", "tau2"),
    "compile": ("count",),
    "checkpoint": ("round",),
    "prefetch": ("action",),
    "flush": ("rounds",),
    "span": (),
    "counters": (),
    "fault": ("kind", "phase"),
    "degraded": ("round", "active_nodes", "masked_edges"),
    "overlap": ("mode", "k"),
}


def make_event(type_: str, t: float, track: str, *,
               name: Optional[str] = None, dur: Optional[float] = None,
               data: Optional[dict] = None) -> dict:
    """Build one schema-shaped event record (no validation — see
    ``validate_event``)."""
    ev: Dict[str, Any] = {"type": type_, "t": float(t), "track": track}
    if name is not None:
        ev["name"] = name
    if dur is not None:
        ev["dur"] = float(dur)
    if data:
        ev["data"] = data
    return ev


def validate_event(ev: Any) -> List[str]:
    """All schema problems with one record (empty list == valid)."""
    problems: List[str] = []
    if not isinstance(ev, dict):
        return [f"event is {type(ev).__name__}, not an object"]
    etype = ev.get("type")
    if etype not in EVENT_TYPES:
        problems.append(f"unknown type {etype!r} (know {sorted(EVENT_TYPES)})")
    t = ev.get("t")
    if not isinstance(t, (int, float)) or isinstance(t, bool) or t < 0:
        problems.append(f"t={t!r} must be a non-negative number "
                        "(monotonic seconds since run start)")
    if not isinstance(ev.get("track"), str) or not ev.get("track"):
        problems.append(f"track={ev.get('track')!r} must be a non-empty "
                        "string")
    dur = ev.get("dur")
    if dur is not None and (not isinstance(dur, (int, float))
                            or isinstance(dur, bool) or dur < 0):
        problems.append(f"dur={dur!r} must be a non-negative number")
    if etype == "span":
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            problems.append("span events require a non-empty 'name'")
        if dur is None:
            problems.append("span events require 'dur'")
    data = ev.get("data", {})
    if not isinstance(data, dict):
        problems.append(f"data={data!r} must be an object")
        data = {}
    for key in REQUIRED_DATA.get(etype, ()):
        if key not in data:
            problems.append(f"{etype!r} event missing required data key "
                            f"{key!r}")
    return problems


def validate_events(events: Iterable[Any]) -> List[Tuple[int, str]]:
    """``(index, problem)`` for every schema violation in the sequence."""
    out: List[Tuple[int, str]] = []
    for i, ev in enumerate(events):
        for p in validate_event(ev):
            out.append((i, p))
    return out


def validate_stream(events: Sequence[Any]) -> List[Tuple[int, str]]:
    """``validate_events`` plus the stream-level contract: non-empty,
    starts with a ``run`` header whose ``schema`` we can read."""
    events = list(events)
    out = validate_events(events)
    if not events:
        return [(0, "empty stream: no 'run' header event")]
    head = events[0]
    if isinstance(head, dict):
        if head.get("type") != "run":
            out.append((0, f"stream must start with a 'run' header event, "
                           f"got {head.get('type')!r}"))
        else:
            schema = head.get("data", {}).get("schema")
            if schema not in KNOWN_SCHEMAS:
                out.append((0, f"run header schema={schema!r}, this reader "
                               f"knows schemas {sorted(KNOWN_SCHEMAS)}"))
    return out


def read_events(path: str) -> List[dict]:
    """Parse a JSONL event file (raises ValueError with the offending
    line number on malformed JSON; schema validation is separate)."""
    events: List[dict] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: malformed JSONL event: {e}") from None
    return events


def write_events(path: str, events: Iterable[dict]) -> int:
    """Write events as JSONL; returns the count written."""
    n = 0
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
            n += 1
    return n
