"""The --history-out JSON as a VIEW derived from the event stream.

``launch/train.py`` used to assemble its history dict by hand alongside
the telemetry; now the stream is the single source of truth and this
module projects it back into the legacy shape (same fields, same
values — ``round`` stays 1-based, ``plan_events`` is the controller's
emission order) plus a ``schema_version`` key so downstream readers can
detect the provenance change.

View schema_version 2 == legacy fields derived from event-stream
schema 1 (``events.SCHEMA_VERSION``). View schema_version 3 adds the
per-round realized-participation columns ``active_nodes`` /
``masked_edges`` (from event-stream schema 2's sporadic rounds; None on
rounds that ran before participation tracking, so full-participation
streams project losslessly) — they are what lets ``repro_torch.obs report``
attribute loss progress to availability. View schema_version 4 adds the
mega-scale cohort columns ``cohort_size`` / ``population`` (batched-
engine rounds sample a C-of-V cohort; ``train.py --virtual-nodes``
stamps both on every round event; None on non-sampled runs, so legacy
streams keep projecting losslessly).
"""
from __future__ import annotations

from typing import Iterable, List

__all__ = ["HISTORY_SCHEMA_VERSION", "history_view"]

HISTORY_SCHEMA_VERSION = 4

# Planner decision types that legacy plan_events carried (the
# controller's ``history`` list mirrored every cause, including
# trajectory chunks and probes).
_PLAN_TYPES = ("plan", "replan", "probe")


def history_view(events: Iterable[dict]) -> dict:
    """Project an event stream into the legacy train.py history JSON."""
    events = list(events)
    history: dict = {
        "schema_version": HISTORY_SCHEMA_VERSION,
        "round": [], "loss": [], "consensus_sq": [],
        "tau1": [], "tau2": [], "round_s": [],
        "active_nodes": [], "masked_edges": [],
        "cohort_size": [], "population": [],
    }
    for ev in events:
        if ev.get("type") != "round":
            continue
        d = ev.get("data", {})
        # Stream records the 0-based realized round index; the legacy
        # column was 1-based.
        history["round"].append(d.get("round", -1) + 1)
        history["loss"].append(d.get("loss"))
        history["consensus_sq"].append(d.get("consensus_sq"))
        history["tau1"].append(d.get("tau1"))
        history["tau2"].append(d.get("tau2"))
        history["round_s"].append(d.get("round_s"))
        # schema-2 sporadic rounds carry realized participation; rounds
        # from older streams (or full-participation executors that don't
        # track it) project as None.
        history["active_nodes"].append(d.get("active_nodes"))
        history["masked_edges"].append(d.get("masked_edges"))
        # schema-4 cohort columns (batched engine / --virtual-nodes).
        history["cohort_size"].append(d.get("cohort_size"))
        history["population"].append(d.get("population"))

    plan_events: List[dict] = [ev.get("data", {}) for ev in events
                               if ev.get("type") in _PLAN_TYPES]
    if plan_events:
        history["plan_events"] = plan_events

    history["schedule"] = [[t1, t2] for t1, t2 in
                           zip(history["tau1"], history["tau2"])]

    # Run-level summary counters (train.py emits one "run-summary"
    # counters event at the end; last writer wins).
    for ev in events:
        if ev.get("type") != "counters":
            continue
        d = ev.get("data", {})
        for key in ("schedule_mode", "compile_count_warmup", "compile_count"):
            if key in d:
                history[key] = d[key]
    return history
