"""The run-wide telemetry sink: thread-safe, monotonic, optionally JSONL.

``Telemetry`` collects schema-shaped events (see ``events.py``) into an
in-memory list and, when given a path, appends each one to a JSONL file
as it is emitted (so a crashed run still leaves a readable stream).

Clock discipline: every ``t`` is ``time.perf_counter()`` seconds since
the sink was constructed — monotonic, immune to wall-clock jumps. The
ONE absolute timestamp lives in the ``run`` header's
``data["wall_start"]`` so exported timelines can still be anchored to
calendar time.

The emit path is deliberately cheap (build a dict, append under a lock,
optionally one buffered ``write``): it is called from the training
loop's host side and from the prefetcher's worker thread, and the
telemetry-overhead bench holds it under 2% of superstep dispatch
throughput. It must never touch torch: the zero-sync, zero-build and
zero-capture contract on the round path is held by the port's tests and
``chip_smoke.py``, and keeping this module stdlib-only makes a device read
impossible to introduce here.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Iterator, List, Optional

from .events import SCHEMA_VERSION, make_event

__all__ = ["Telemetry", "NullTelemetry"]


class Telemetry:
    """Typed event sink with span tracing on a monotonic clock.

    >>> tel = Telemetry(meta={"arch": "quad"})
    >>> with tel.span("gossip-flush", track="metrics"):
    ...     pass
    >>> [e["type"] for e in tel.events]
    ['run', 'span']
    """

    def __init__(self, path: Optional[str] = None, meta: Optional[dict] = None):
        self._t0 = time.perf_counter()
        self.wall_start = time.time()
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._file = open(path, "w", buffering=1) if path else None
        self.path = path
        header = {"schema": SCHEMA_VERSION, "wall_start": self.wall_start}
        if meta:
            header.update(meta)
        self.emit("run", track="run", name="run", t=0.0, **header)

    # -- clock ---------------------------------------------------------
    def now(self) -> float:
        """Monotonic seconds since this run's origin."""
        return time.perf_counter() - self._t0

    # -- emission ------------------------------------------------------
    def emit(self, type_: str, *, track: str = "run",
             name: Optional[str] = None, t: Optional[float] = None,
             dur: Optional[float] = None, **data) -> dict:
        """Record one event; ``data`` kwargs become the typed payload.

        ``t`` defaults to now; pass an explicit earlier ``t`` (plus
        ``dur``) for span-like events stamped at their start.
        """
        ev = make_event(type_, self.now() if t is None else t, track,
                        name=name, dur=dur, data=data or None)
        with self._lock:
            self._events.append(ev)
            if self._file is not None:
                self._file.write(json.dumps(ev) + "\n")
        return ev

    @contextlib.contextmanager
    def span(self, name: str, track: str = "run", **data) -> Iterator[None]:
        """Time a host-side region as a named span on ``track``."""
        t0 = self.now()
        try:
            yield
        finally:
            self.emit("span", track=track, name=name, t=t0,
                      dur=self.now() - t0, **data)

    # -- access --------------------------------------------------------
    @property
    def events(self) -> List[dict]:
        """Snapshot of the events emitted so far (copy — safe to mutate)."""
        with self._lock:
            return list(self._events)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullTelemetry:
    """No-op drop-in: same surface as ``Telemetry``, records nothing.

    Instrumented code may take ``telemetry=None`` OR a ``NullTelemetry``;
    the former skips even the call, the latter keeps call sites
    unconditional where branching would be noisier.
    """

    path = None
    wall_start = 0.0

    def now(self) -> float:
        return 0.0

    def emit(self, type_: str, **kwargs) -> dict:
        return {}

    @contextlib.contextmanager
    def span(self, name: str, track: str = "run", **data) -> Iterator[None]:
        yield

    @property
    def events(self) -> List[dict]:
        return []

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullTelemetry":
        return self

    def __exit__(self, *exc) -> None:
        pass
