"""The port's telemetry (``repro_torch.obs``), a copy of ``repro.obs``.

The reference's ``tests/test_obs.py`` cases, run against the port's
package: the schema, the sink, the trace export, the report, the history
view and the CLI (``python -m repro_torch.obs``). Then the copy against the
reference: the same schema constants; ``run_report``, ``history_view`` and
``to_chrome_trace`` give the same dicts in both packages on the same
events; a stream the port's ``RoundExecutor`` writes validates under the
reference's ``repro.obs``, and the reference's under the port's; and the
reference's 8-node ring session through the port's train CLI on the CPU.
"""
import json
import subprocess
import sys
import threading
import time

import pytest

from repro_torch.obs import (
    EVENT_TYPES, HISTORY_SCHEMA_VERSION, SCHEMA_VERSION, NullTelemetry,
    Telemetry, export_chrome_trace, history_view, make_event, read_events,
    run_report, format_report, to_chrome_trace, trace_track_names,
    validate_event, validate_events, validate_stream, write_events)


# ---------------------------------------------------------------------------
# event schema
# ---------------------------------------------------------------------------


def test_make_event_validates_and_round_trips():
    ev = make_event("round", 1.25, "rounds", name="round-3",
                    data={"round": 3, "tau1": 2, "tau2": 1, "round_s": 0.1})
    assert validate_event(ev) == []
    assert ev["type"] == "round" and ev["t"] == 1.25
    assert json.loads(json.dumps(ev)) == ev


def test_validate_event_rejects_unknown_type_and_missing_keys():
    bad_type = make_event("explosion", 0.0, "run")
    assert any("type" in p for p in validate_event(bad_type))
    # each type's REQUIRED_DATA keys are mandatory: a round without taus
    # is a malformed record, not a partial one.
    bad_data = make_event("round", 0.0, "rounds", data={"round": 1})
    probs = validate_event(bad_data)
    assert any("tau1" in p for p in probs)
    # spans additionally need a name and a duration.
    bad_span = make_event("span", 0.0, "dispatch")
    probs = validate_event(bad_span)
    assert any("name" in p for p in probs) and any("dur" in p for p in probs)


def test_validate_stream_requires_run_header():
    ev = make_event("superstep", 0.1, "dispatch", data={"k": 4})
    assert validate_stream([]) != []
    assert validate_stream([ev]) != []      # first record must be "run"
    run = make_event("run", 0.0, "run",
                     data={"schema": SCHEMA_VERSION,
                           "wall_start": 1700000000.0})
    assert validate_stream([run, ev]) == []
    stale = make_event("run", 0.0, "run",
                       data={"schema": SCHEMA_VERSION + 99,
                             "wall_start": 0.0})
    assert any("schema" in problem
               for _, problem in validate_stream([stale, ev]))


def test_jsonl_write_read_round_trip(tmp_path):
    evs = [make_event("run", 0.0, "run",
                      data={"schema": SCHEMA_VERSION, "wall_start": 1.0}),
           make_event("compile", 0.5, "dispatch", name="trace",
                      data={"count": 1})]
    p = tmp_path / "events.jsonl"
    write_events(str(p), evs)
    assert read_events(str(p)) == evs
    p.write_text(p.read_text() + "{not json\n")
    with pytest.raises(ValueError, match=r":3: malformed"):
        read_events(str(p))


# ---------------------------------------------------------------------------
# the sink
# ---------------------------------------------------------------------------


def test_telemetry_emits_run_header_and_monotonic_stamps():
    tel = Telemetry(meta={"run": "unit"})
    tel.emit("superstep", track="dispatch", name="superstep-k4", k=4)
    evs = tel.events
    assert evs[0]["type"] == "run"
    assert evs[0]["data"]["schema"] == SCHEMA_VERSION
    assert evs[0]["data"]["run"] == "unit"   # meta merges into the header
    assert validate_stream(evs) == []
    # t is seconds since the sink's perf_counter origin: small, not epoch.
    assert 0.0 <= evs[1]["t"] < 60.0


def test_telemetry_span_stamps_entry_time_and_duration():
    tel = Telemetry()
    with tel.span("gossip-flush", track="dispatch", rounds=4):
        time.sleep(0.02)
    ev = tel.events[-1]
    assert ev["type"] == "span" and ev["name"] == "gossip-flush"
    assert ev["dur"] >= 0.02
    assert ev["data"]["rounds"] == 4
    # t is the span START: the event lands at scope exit, stamped at entry.
    assert ev["t"] + ev["dur"] <= tel.now() + 1e-9


def test_telemetry_span_records_even_when_body_raises():
    tel = Telemetry()
    with pytest.raises(RuntimeError):
        with tel.span("doomed", track="run"):
            raise RuntimeError("boom")
    assert tel.events[-1]["name"] == "doomed"


def test_telemetry_jsonl_file_mirrors_memory(tmp_path):
    p = tmp_path / "tel.jsonl"
    with Telemetry(path=str(p)) as tel:
        tel.emit("checkpoint", track="checkpoint", round=2)
        in_memory = tel.events
    assert read_events(str(p)) == in_memory
    assert validate_stream(in_memory) == []


def test_telemetry_concurrent_emits_are_not_lost():
    tel = Telemetry()

    def worker(i):
        for j in range(50):
            tel.emit("prefetch", track="prefetch", name=f"w{i}",
                     action="build")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = tel.events
    assert len(evs) == 1 + 4 * 50
    assert validate_events(evs) == []


def test_null_telemetry_is_a_no_op_with_the_same_surface():
    tel = NullTelemetry()
    tel.emit("round", track="rounds", round=0, tau1=1, tau2=1, round_s=0.0)
    with tel.span("anything", track="run"):
        pass
    assert tel.events == []
    assert tel.now() >= 0.0
    tel.close()


# ---------------------------------------------------------------------------
# trace export + report + history view
# ---------------------------------------------------------------------------


def _sample_events():
    tel = Telemetry(meta={"run": "sample"})
    with tel.span("warmup", track="dispatch"):
        pass
    tel.emit("compile", track="dispatch", name="superstep-trace-dynamic",
             count=1)
    tel.emit("superstep", track="dispatch", name="superstep-k4",
             dur=0.2, k=4)
    tel.emit("plan", track="planner", name="initial", tau1=2, tau2=1,
             cause="initial", round=0)
    tel.emit("round", track="rounds", name="round-0", round=0, tau1=2,
             tau2=1, loss=2.0, consensus_sq=0.5, round_s=0.05)
    tel.emit("round", track="rounds", name="round-1", round=1, tau1=2,
             tau2=1, loss=1.5, consensus_sq=0.4, round_s=0.05)
    tel.emit("flush", track="metrics", name="metrics-flush", dur=0.01,
             rounds=2)
    tel.emit("counters", track="dispatch", name="superstep-counters",
             compile_count=1, kernel_pallas_calls=3)
    tel.emit("counters", track="run", name="run-summary",
             schedule_mode="fixed", compile_count_warmup=1,
             compile_count=1, kernel_pallas_calls=2)
    return tel.events


def test_chrome_trace_has_named_tracks_slices_and_instants():
    trace = to_chrome_trace(_sample_events())
    names = set(trace_track_names(trace))
    assert {"dispatch", "planner", "rounds", "metrics"} <= names
    assert len(names) >= 4
    slices = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert any(s["name"] == "superstep-k4" and s["dur"] == pytest.approx(2e5)
               for s in slices)
    instants = [e for e in trace["traceEvents"] if e["ph"] == "i"]
    assert any(i["name"] == "round-0" for i in instants)
    # every non-metadata event maps to a declared track tid.
    tids = {e["tid"] for e in trace["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert all(e["tid"] in tids for e in trace["traceEvents"])


def test_export_chrome_trace_writes_loadable_json(tmp_path):
    p = tmp_path / "trace.json"
    export_chrome_trace(_sample_events(), str(p))
    trace = json.loads(p.read_text())
    assert len(trace_track_names(trace)) >= 4


def test_run_report_aggregates_spans_counters_and_rounds():
    rep = run_report(_sample_events())
    assert rep["rounds"]["rounds"] == 2
    assert rep["rounds"]["loss_first"] == 2.0
    assert rep["rounds"]["loss_last"] == 1.5
    assert rep["plans"]["initial"] == 1
    # kernel_* counter keys SUM across snapshots; others are last-wins.
    assert rep["counters"]["kernel_pallas_calls"] == 5
    assert rep["counters"]["compile_count"] == 1
    text = format_report(rep)
    assert "rounds" in text and "kernel_pallas_calls" in text


def test_history_view_reproduces_legacy_contract():
    h = history_view(_sample_events())
    assert h["schema_version"] == HISTORY_SCHEMA_VERSION
    assert h["round"] == [1, 2]              # 1-based, like the old dict
    assert h["tau1"] == [2, 2] and h["tau2"] == [1, 1]
    assert h["loss"] == [2.0, 1.5]
    assert h["schedule"] == [[2, 1], [2, 1]]
    assert h["plan_events"][0]["cause"] == "initial"
    assert h["schedule_mode"] == "fixed"
    assert h["compile_count"] == 1 and h["compile_count_warmup"] == 1


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.obs {validate, trace export, report}
# ---------------------------------------------------------------------------


def _run_obs_cli(args, cwd):
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.obs", *args],
                          env=env, cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_obs_cli_validate_trace_report(tmp_path):
    src = tmp_path / "events.jsonl"
    write_events(str(src), _sample_events())

    ok = _run_obs_cli(["validate", str(src), "--min-tracks", "4"], tmp_path)
    assert ok.returncode == 0, ok.stdout + ok.stderr

    out = tmp_path / "trace.json"
    tr = _run_obs_cli(["trace", "export", str(src), "--out", str(out)],
                      tmp_path)
    assert tr.returncode == 0, tr.stdout + tr.stderr
    assert len(trace_track_names(json.loads(out.read_text()))) >= 4

    rep_json = tmp_path / "report.json"
    rp = _run_obs_cli(["report", str(src), "--json", str(rep_json)],
                      tmp_path)
    assert rp.returncode == 0, rp.stdout + rp.stderr
    assert json.loads(rep_json.read_text())["rounds"]["rounds"] == 2


def test_obs_cli_validate_rejects_bad_stream(tmp_path):
    src = tmp_path / "bad.jsonl"
    # no run header: a truncated/hand-rolled stream must not validate.
    write_events(str(src), [make_event("superstep", 0.0, "dispatch",
                                       data={"k": 2})])
    bad = _run_obs_cli(["validate", str(src)], tmp_path)
    assert bad.returncode != 0


# ---------------------------------------------------------------------------
# the copy against the reference
# ---------------------------------------------------------------------------


def test_schema_constants_equal_reference():
    import repro.obs as jobs
    import repro_torch.obs as tobs

    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION == 3
    assert tobs.KNOWN_SCHEMAS == jobs.KNOWN_SCHEMAS
    assert tobs.EVENT_TYPES == jobs.EVENT_TYPES
    assert tobs.REQUIRED_DATA == jobs.REQUIRED_DATA
    assert tobs.HISTORY_SCHEMA_VERSION == jobs.HISTORY_SCHEMA_VERSION
    assert tobs.__all__ == jobs.__all__


def _executor_events():
    """A stream of the port's executor: a warmup and a pipelined
    trajectory, the prefetcher and a metrics flush."""
    import numpy as np
    import torch

    from repro_torch.core import (DFLConfig, HostPrefetcher, MetricsBuffer,
                                  RoundExecutor, init_state, ring,
                                  stack_round_batches)
    from repro_torch.optim import sgd

    tel = Telemetry(meta={"run": "executor"})
    opt = sgd(0.1)
    cfg = DFLConfig(tau1=2, tau2=2, topology=ring(4))
    ex = RoundExecutor(cfg, lambda p, b: torch.mean((p["w"] - b["t"]) ** 2),
                       opt, overlap="pipeline", telemetry=tel)
    rng = np.random.default_rng(0)
    pf = HostPrefetcher(telemetry=tel)
    pf.schedule(lambda: [{"t": rng.normal(size=(2, 4, 3)).astype(
        np.float32)} for _ in range(3)], meta=0)
    host, _ = pf.take()
    pf.close()
    batches = stack_round_batches(host, 2, "cpu")
    state = init_state({"w": torch.zeros(3)}, 4, opt)
    ex.warmup(state, batches)
    buf = MetricsBuffer(telemetry=tel)
    state, m = ex.dispatch_trajectory(state, batches,
                                      np.array([[2, 2], [1, 1], [2, 0]]))
    buf.push(0, 3, None, None, m)
    for row in buf.flush():
        tel.emit("round", track="rounds", name=f"round-{row['round']}",
                 **row)
    return tel.events


def test_executor_stream_validates_under_the_reference():
    from repro.obs import validate_stream as jvalidate_stream

    events = _executor_events()
    assert validate_stream(events) == [] == jvalidate_stream(events)
    types = {e["type"] for e in events}
    assert {"run", "compile", "superstep", "overlap", "prefetch", "flush",
            "span", "round"} <= types
    # and the reference's stream validates under the port's package
    from repro.obs import Telemetry as JTelemetry
    jtel = JTelemetry(meta={"run": "reference"})
    jtel.emit("superstep", track="dispatch", name="superstep-k4", k=4)
    assert validate_stream(jtel.events) == []


@pytest.mark.parametrize("which", ["sample", "executor"])
def test_report_history_and_trace_equal_reference(which):
    import repro.obs as jobs

    events = _sample_events() if which == "sample" else _executor_events()
    assert run_report(events) == jobs.run_report(events)
    assert format_report(run_report(events)).splitlines()[:-1] == \
        jobs.format_report(jobs.run_report(events)).splitlines()[:-1]
    assert history_view(events) == jobs.history_view(events)
    assert to_chrome_trace(events) == jobs.to_chrome_trace(events)


def test_train_cli_eight_ring_telemetry_session(tmp_path):
    """The reference's acceptance session through the port's train CLI on
    the CPU: --telemetry-out on an 8-node ring, the stream valid, the
    history its view, the trace with >= 4 named tracks."""
    from repro_torch.launch import train as train_cli

    events_out = tmp_path / "events.jsonl"
    hist_out = tmp_path / "hist.json"
    train_cli.main([
        "--arch", "qwen3-1.7b", "--nodes", "8", "--topology", "ring",
        "--rounds", "3", "--batch", "1", "--seq", "16",
        "--plan-budget", "3600", "--replan-every", "1", "--log-every", "10",
        "--telemetry-out", str(events_out), "--history-out", str(hist_out),
        "--device", "cpu"])

    evs = read_events(str(events_out))
    assert validate_stream(evs) == []
    types = {e["type"] for e in evs}
    assert {"run", "round", "plan", "compile", "superstep",
            "counters"} <= types
    rounds = [e for e in evs if e["type"] == "round"]
    assert len(rounds) == 3
    assert all("wire_bits" in e["data"] for e in rounds)

    trace_out = tmp_path / "trace.json"
    export_chrome_trace(evs, str(trace_out))
    assert len(trace_track_names(json.loads(trace_out.read_text()))) >= 4

    h = json.loads(hist_out.read_text())
    assert h == history_view(evs)
    assert h["round"] == [1, 2, 3]
    assert h["compile_count"] >= 1
