"""Run report: a per-phase cost breakdown computed from the event stream.

Answers "where did the wall-clock go" (span time per track), "what did
the run cost" (wire bits, builds and captures, kernel-counter deltas, prefetch
hit/stale), and "what happened" (rounds, schedule usage, plan/replan/
probe decisions) — all from the JSONL stream, no live process needed.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Tuple

__all__ = ["run_report", "format_report"]


def run_report(events: Iterable[dict]) -> dict:
    """Aggregate a stream into a report dict (see ``format_report``)."""
    events = list(events)
    header = next((e for e in events if e.get("type") == "run"), None)

    # Wall-clock attribution: total duration per (track, name) over every
    # event that carries a dur (spans, supersteps, flushes, checkpoints,
    # prefetch builds...).
    spans: Dict[Tuple[str, str], Dict[str, float]] = {}
    t_end = 0.0
    for ev in events:
        t_end = max(t_end, float(ev.get("t", 0.0)) + float(ev.get("dur") or 0.0))
        if ev.get("dur") is None:
            continue
        key = (ev.get("track", "run"), ev.get("name") or ev.get("type"))
        slot = spans.setdefault(key, {"count": 0, "total_s": 0.0})
        slot["count"] += 1
        slot["total_s"] += float(ev["dur"])

    # Rounds: realized schedule + losses.
    rounds = [e["data"] for e in events
              if e.get("type") == "round" and isinstance(e.get("data"), dict)]
    round_summary = {}
    if rounds:
        taus = Counter((r.get("tau1"), r.get("tau2")) for r in rounds)
        losses = [r["loss"] for r in rounds if isinstance(
            r.get("loss"), (int, float))]
        round_summary = {
            "rounds": len(rounds),
            "round_s_total": sum(float(r.get("round_s", 0.0)) for r in rounds),
            "schedule_counts": {f"({t1},{t2})": n
                                for (t1, t2), n in sorted(taus.items(),
                                                          key=lambda kv: -kv[1])},
        }
        if losses:
            round_summary["loss_first"] = losses[0]
            round_summary["loss_last"] = losses[-1]

    # Availability attribution (schema 2): how much of the run's loss
    # progress happened in full vs degraded rounds, and the realized
    # participation rates — the report's answer to "did the sporadic
    # engine actually keep learning through the faults".
    part = [r for r in rounds
            if isinstance(r.get("active_nodes"), (int, float))
            and isinstance(r.get("masked_edges"), (int, float))]
    availability = {}
    if part:
        degraded = [r for r in part if r.get("degraded")]
        availability = {
            "rounds_tracked": len(part),
            "rounds_degraded": len(degraded),
            "mean_active_nodes": (sum(r["active_nodes"] for r in part)
                                  / len(part)),
            "mean_masked_edges": (sum(r["masked_edges"] for r in part)
                                  / len(part)),
        }
        for name, sel in (("full", [r for r in part
                                    if not r.get("degraded")]),
                          ("degraded", degraded)):
            ls = [r["loss"] for r in sel
                  if isinstance(r.get("loss"), (int, float))]
            if len(ls) >= 1:
                availability[f"loss_delta_{name}"] = ls[-1] - ls[0]
    faults = Counter(
        f"{e['data'].get('kind', '?')}:{e['data'].get('phase', '?')}"
        for e in events
        if e.get("type") == "fault" and isinstance(e.get("data"), dict))

    # Overlap (schema 3): pipelined supersteps' in-flight gossip slices —
    # how much of the run executed with the wire riding under compute.
    overlap_evs = [e for e in events if e.get("type") == "overlap"]
    overlap = {}
    if overlap_evs:
        overlap = {
            "supersteps": len(overlap_evs),
            "mode": (overlap_evs[-1].get("data") or {}).get("mode", "?"),
            "inflight_s": sum(float(e.get("dur") or 0.0)
                              for e in overlap_evs),
        }

    # Planner decisions.
    plan_counts = Counter(e.get("data", {}).get("cause", e["type"])
                          for e in events
                          if e.get("type") in ("plan", "replan", "probe"))

    # Counters: the final snapshot wins for cumulative values; kernel_*
    # keys are per-superstep deltas so they sum.
    counters: Dict[str, float] = {}
    kernel_totals: Dict[str, float] = {}
    for ev in events:
        if ev.get("type") != "counters":
            continue
        for k, v in (ev.get("data") or {}).items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            if k.startswith("kernel_"):
                kernel_totals[k] = kernel_totals.get(k, 0) + v
            else:
                counters[k] = v
    counters.update(kernel_totals)

    compiles = [e["data"]["count"] for e in events
                if e.get("type") == "compile"
                and isinstance(e.get("data"), dict) and "count" in e["data"]]

    return {
        "meta": (header or {}).get("data", {}),
        "duration_s": t_end,
        "events": len(events),
        "tracks": sorted({e.get("track", "run") for e in events}),
        "spans": {f"{track}:{name}": stat
                  for (track, name), stat in sorted(
                      spans.items(), key=lambda kv: -kv[1]["total_s"])},
        "rounds": round_summary,
        "availability": availability,
        "overlap": overlap,
        "faults": dict(faults),
        "plans": dict(plan_counts),
        "counters": counters,
        "compiles_seen": max(compiles) if compiles else 0,
    }


def format_report(rep: dict) -> str:
    """Human-readable rendering of ``run_report`` output."""
    lines: List[str] = []
    meta = rep.get("meta", {})
    label = meta.get("arch") or meta.get("name") or "run"
    lines.append(f"run report — {label}")
    lines.append(f"  duration {rep['duration_s']:.3f}s over {rep['events']} "
                 f"events on tracks: {', '.join(rep['tracks'])}")

    if rep.get("rounds"):
        r = rep["rounds"]
        lines.append(f"  rounds: {r['rounds']} "
                     f"({r['round_s_total']:.3f}s amortized)")
        if "loss_first" in r:
            lines.append(f"    loss {r['loss_first']:.4f} -> "
                         f"{r['loss_last']:.4f}")
        sched = ", ".join(f"{k}x{n}" for k, n in r["schedule_counts"].items())
        lines.append(f"    schedule (tau1,tau2): {sched}")

    if rep.get("availability"):
        a = rep["availability"]
        lines.append(
            f"  availability: {a['rounds_degraded']}/{a['rounds_tracked']} "
            f"rounds degraded, mean active nodes "
            f"{a['mean_active_nodes']:.2f}, mean masked edges "
            f"{a['mean_masked_edges']:.2f}")
        for name in ("full", "degraded"):
            key = f"loss_delta_{name}"
            if key in a:
                lines.append(f"    loss delta over {name} rounds: "
                             f"{a[key]:+.4f}")
    if rep.get("overlap"):
        o = rep["overlap"]
        lines.append(f"  overlap: mode={o['mode']} over {o['supersteps']} "
                     f"superstep(s), {o['inflight_s']:.3f}s gossip in "
                     f"flight under compute")

    if rep.get("faults"):
        fl = ", ".join(f"{k}x{n}" for k, n in sorted(rep["faults"].items()))
        lines.append(f"  faults: {fl}")

    if rep.get("plans"):
        plans = ", ".join(f"{k}={n}" for k, n in sorted(rep["plans"].items()))
        lines.append(f"  planner: {plans}")

    if rep.get("spans"):
        lines.append("  wall-clock by span (track:name  count  total):")
        for key, stat in rep["spans"].items():
            lines.append(f"    {key:<32s} {stat['count']:>5d}  "
                         f"{stat['total_s']:>9.3f}s")

    if rep.get("counters"):
        lines.append("  counters (final / summed deltas):")
        for k, v in sorted(rep["counters"].items()):
            lines.append(f"    {k:<32s} {v}")
    if rep.get("compiles_seen"):
        lines.append(f"  builds and graph captures observed: "
                     f"{rep['compiles_seen']}")
    return "\n".join(lines)
