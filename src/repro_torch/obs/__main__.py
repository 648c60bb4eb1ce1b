"""Telemetry CLI: validate / trace export / report over a JSONL stream.

    python -m repro_torch.obs validate events.jsonl [--min-tracks 4]
    python -m repro_torch.obs trace export events.jsonl --out trace.json
    python -m repro_torch.obs report events.jsonl [--json report.json]

Stdlib-only (no torch): runs anywhere the JSONL file can be copied.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.events import read_events, validate_stream
from repro_torch.obs.report import format_report, run_report
from repro_torch.obs.trace import export_chrome_trace, trace_track_names


def _load(path: str):
    try:
        return read_events(path)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(1)


def _cmd_validate(args) -> int:
    events = _load(args.events)
    problems = validate_stream(events)
    for i, msg in problems:
        print(f"{args.events}:{i + 1}: {msg}")
    tracks = sorted({e.get("track") for e in events
                     if isinstance(e, dict) and e.get("track")})
    if args.min_tracks and len(tracks) < args.min_tracks:
        problems.append((0, "tracks"))
        print(f"{args.events}: only {len(tracks)} tracks "
              f"({', '.join(tracks)}), need >= {args.min_tracks}")
    if problems:
        print(f"INVALID: {len(problems)} problem(s) in {len(events)} events")
        return 1
    print(f"OK: {len(events)} events, {len(tracks)} tracks "
          f"({', '.join(tracks)})")
    return 0


def _cmd_trace_export(args) -> int:
    events = _load(args.events)
    trace = export_chrome_trace(events, args.out)
    names = trace_track_names(trace)
    print(f"trace -> {args.out} ({len(trace['traceEvents'])} trace events, "
          f"{len(names)} tracks: {', '.join(names)})")
    print("load it at https://ui.perfetto.dev or chrome://tracing")
    return 0


def _cmd_report(args) -> int:
    events = _load(args.events)
    rep = run_report(events)
    print(format_report(rep))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1)
        print(f"report json -> {args.json}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("validate",
                       help="schema-validate a JSONL event stream")
    v.add_argument("events")
    v.add_argument("--min-tracks", type=int, default=0,
                   help="also require at least N distinct tracks")
    v.set_defaults(fn=_cmd_validate)

    t = sub.add_parser("trace", help="timeline export")
    tsub = t.add_subparsers(dest="trace_cmd", required=True)
    te = tsub.add_parser("export",
                         help="render Chrome trace-event / Perfetto JSON")
    te.add_argument("events")
    te.add_argument("--out", required=True)
    te.set_defaults(fn=_cmd_trace_export)

    r = sub.add_parser("report", help="per-phase run cost breakdown")
    r.add_argument("events")
    r.add_argument("--json", default="")
    r.set_defaults(fn=_cmd_report)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
