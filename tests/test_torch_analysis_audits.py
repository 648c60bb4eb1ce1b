"""The port's audits (``repro_torch.analysis.audits``) against the
reference's (``repro.analysis.audits``).

Each audit function is pure over records, so each must (a) pass on a sound
record and (b) FAIL on its broken fixture — a moved ``data_ptr``, a count
that rose, a state one bit apart, a sink with no ``compile`` event, a
dropped shift, a wrong shift, an extra pair — or the audit is decoration.
Real broken artifacts too: an executor built with ``donate=False`` and the
static fallback across two schedules. ``expected_shift_pairs`` equals the
reference's on ring(4), ring(8), ring(10) and fully_connected(8). The
production audits run through the CLI on ``--device cpu`` in a subprocess
with its own time limit (8 gloo ranks spawned once), and their nine names
are the reference's, read off its ``run_production_audits`` source.
"""
import ast
import collections
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.analysis import audits as ref_audits
from repro.core import topology as ref_topology
from repro_torch.analysis import audits
from repro_torch.analysis.audits import (
    AuditResult, audit_collective_matching, audit_donation, audit_recompile,
    audit_telemetry_neutrality, build_audit_executor, dispatch_record,
    expected_shift_pairs, state_pointers, tensor_digest)
from repro_torch.core import topology

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _reference_audit_names():
    """The ``name`` of each result ``repro.analysis.audits.
    run_production_audits`` returns, in order: its ``name=`` keyword, or
    the audit function's default."""
    tree = ast.parse(inspect.getsource(ref_audits))
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}

    def default_name(fn):
        args = funcs[fn].args
        pos = args.args[len(args.args) - len(args.defaults):]
        return {a.arg: d.value for a, d in zip(pos, args.defaults)}["name"]

    ret = [n for n in ast.walk(funcs["run_production_audits"])
           if isinstance(n, ast.Return)][-1].value
    names = []
    for call in ret.elts:
        kw = {k.arg: k.value.value for k in call.keywords if k.arg == "name"}
        names.append(kw.get("name", default_name(call.func.id)))
    return names


def test_audit_names_are_the_reference_list():
    assert list(audits.AUDIT_NAMES) == _reference_audit_names()
    assert len(set(audits.AUDIT_NAMES)) == 9


def test_audit_result_matches_the_reference_dataclass():
    assert [f.name for f in dataclasses.fields(AuditResult)] == [
        f.name for f in dataclasses.fields(ref_audits.AuditResult)]
    r = AuditResult("x", True, "fine", {"k": 1})
    assert r.to_dict() == ref_audits.AuditResult(
        "x", True, "fine", {"k": 1}).to_dict() == {
            "name": "x", "ok": True, "detail": "fine", "data": {"k": 1}}


@pytest.mark.parametrize("make,n", [("ring", 4), ("ring", 8), ("ring", 10),
                                    ("fully_connected", 8)])
def test_expected_shift_pairs_equal_the_reference(make, n):
    got = expected_shift_pairs(getattr(topology, make)(n))
    want = ref_audits.expected_shift_pairs(getattr(ref_topology, make)(n))
    assert got == want and got


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------


def test_audit_donation_passes_on_kept_pointers():
    ptrs = {"params/w": 100, "opt_state/step": 200}
    res = audit_donation(ptrs, dict(ptrs))
    assert res.ok, res.detail
    assert res.data == {"leaves": 2, "moved": []}


def test_audit_donation_fails_on_a_moved_pointer():
    before = {"params/w": 100, "opt_state/step": 200}
    res = audit_donation(before, {"params/w": 100, "opt_state/step": 208})
    assert not res.ok and res.data["moved"] == ["opt_state/step"]
    assert "opt_state/step" in res.detail and "donate" in res.detail
    assert not audit_donation(before, {"params/w": 100}).ok
    assert not audit_donation({}, {}).ok


@pytest.mark.parametrize("donate", [True, False])
def test_audit_donation_on_the_executor(donate):
    ex, state, batches, _ = build_audit_executor(4, device="cpu",
                                                 donate=donate)
    ex.warmup(state, batches)
    before = state_pointers(state)
    assert set(before) == {"params/w", "opt_state/step"}
    out, _ = ex.dispatch_trajectory(state, batches, audits.TAUS_A)
    res = audit_donation(before, state_pointers(out))
    assert res.ok is donate, res.detail


# ---------------------------------------------------------------------------
# recompile
# ---------------------------------------------------------------------------


def test_audit_recompile_passes_on_unmoved_counts():
    res = audit_recompile([(1, 4), (1, 4), (1, 4)],
                          labels=["warmup", "a", "b"])
    assert res.ok, res.detail
    assert res.data["counts"]["b"] == {"builds": 1, "captures": 4}


@pytest.mark.parametrize("counts", [[(1, 4), (2, 4)], [(1, 4), (1, 4),
                                                        (1, 5)]])
def test_audit_recompile_fails_on_a_count_that_rose(counts):
    res = audit_recompile(counts)
    assert not res.ok and "moved" in res.detail


def test_audit_recompile_needs_a_dispatch():
    assert not audit_recompile([(1, 4)]).ok


def test_audit_recompile_fails_on_the_static_fallback():
    """The static fallback builds one round per (tau1, tau2): a real
    executor that a schedule value reaches."""
    ex, state, batches, _ = build_audit_executor(4, device="cpu",
                                                 dynamic=False)
    ex.warmup(state, batches)
    counts = [(ex.compile_count, ex.capture_count)]
    for taus in (audits.TAUS_A, audits.TAUS_B):
        state, _ = ex.dispatch_trajectory(state, batches, taus)
        counts.append((ex.compile_count, ex.capture_count))
    assert not audit_recompile(counts).ok


# ---------------------------------------------------------------------------
# telemetry neutrality
# ---------------------------------------------------------------------------


def _record(digest="ab", builds=1, captures=4):
    return {"digest": digest, "round_idx": 2, "builds": builds,
            "captures": captures}


COMPILED = [{"type": "run"}, {"type": "compile", "data": {"count": 1}}]


def test_audit_telemetry_neutrality_passes_on_equal_records():
    res = audit_telemetry_neutrality(_record(), _record(), COMPILED)
    assert res.ok, res.detail
    assert res.data["compile_events"] == 1


def test_audit_telemetry_neutrality_fails_on_a_state_one_bit_apart():
    ex, state, batches, _ = build_audit_executor(4, device="cpu")
    state, m = ex.dispatch_trajectory(state, batches, audits.TAUS_A)
    bare = dispatch_record(ex, state, m)
    w = state.params["w"]
    w.view(torch.int32)[1, 3] ^= 1            # one bit of one element
    flipped = dispatch_record(ex, state, m)
    assert flipped["digest"] != bare["digest"]
    res = audit_telemetry_neutrality(bare, flipped, COMPILED)
    assert not res.ok and "CHANGED" in res.detail


def test_audit_telemetry_neutrality_fails_without_a_compile_event():
    res = audit_telemetry_neutrality(_record(), _record(), [{"type": "run"}])
    assert not res.ok and "vacuous" in res.detail


def test_audit_telemetry_neutrality_fails_on_another_capture():
    res = audit_telemetry_neutrality(_record(), _record(captures=5),
                                     COMPILED)
    assert not res.ok and "captures" in res.detail


def test_tensor_digest_reads_dtype_shape_and_bytes():
    x = torch.arange(6, dtype=torch.float32)
    base = tensor_digest([x])
    assert tensor_digest([x.clone()]) == base
    assert tensor_digest([x.reshape(2, 3)]) != base
    assert tensor_digest([x.to(torch.int32)]) != base
    y = x.clone()
    y[5] = -y[5]
    assert tensor_digest([y]) != base
    assert tensor_digest([torch.tensor(-0.0)]) != tensor_digest(
        [torch.tensor(0.0)])


# ---------------------------------------------------------------------------
# collective matching
# ---------------------------------------------------------------------------


def _sends(shifts, n=8, steps=2):
    return collections.Counter({(s, (s + sh) % n): steps for sh in shifts
                                for s in range(n)})


def test_audit_collective_matching_passes_on_ring8_sends():
    res = audit_collective_matching(
        _sends([1, 7]), topology.ring(8), gossip_steps=2,
        bytes_sent={r: 576 for r in range(8)}, packed_bytes=144)
    assert res.ok, res.detail
    assert res.data["num_sends"] == 32 and res.data["bytes_per_rank"] == 576


def test_audit_collective_matching_fails_on_a_dropped_shift():
    res = audit_collective_matching(_sends([1]), topology.ring(8))
    assert not res.ok and "missing" in res.detail


def test_audit_collective_matching_fails_on_a_wrong_shift():
    # shift 2 instead of 7: one expected set missing, one unexpected
    res = audit_collective_matching(_sends([1, 2]), topology.ring(8))
    assert not res.ok
    assert res.data["observed"] != res.data["expected"]
    assert "unexpected [[" in res.detail


def test_audit_collective_matching_fails_on_an_extra_pair():
    extra = _sends([1, 7]) + collections.Counter({(0, 3): 1})
    res = audit_collective_matching(extra, topology.ring(8))
    assert not res.ok and "[[0, 3]]" in res.detail


def test_audit_collective_matching_fails_on_a_missing_send():
    short = _sends([1, 7]) - collections.Counter({(0, 1): 1})
    res = audit_collective_matching(short, topology.ring(8), gossip_steps=2)
    assert not res.ok and "0->1" in res.detail


def test_audit_collective_matching_fails_on_wrong_bytes():
    res = audit_collective_matching(
        _sends([1, 7]), topology.ring(8), gossip_steps=2,
        bytes_sent={r: 576 for r in range(7)}, packed_bytes=144)
    assert not res.ok and res.data["ranks_missing"] == [7]
    res = audit_collective_matching(
        _sends([1, 7]), topology.ring(8), gossip_steps=2,
        bytes_sent={**{r: 576 for r in range(8)}, 3: 432}, packed_bytes=144)
    assert not res.ok and res.data["wrong_bytes"] == {3: 432}


def test_audit_collective_matching_needs_sends_when_shifted():
    assert not audit_collective_matching({}, topology.ring(8)).ok
    assert audit_collective_matching({}, topology.disconnected(4)).ok


def test_audit_collective_matching_fully_connected_every_shift():
    topo = topology.fully_connected(4)
    shifts = [s for s, _ in topo.shifts()]
    assert audit_collective_matching(_sends(shifts, n=4), topo).ok
    assert not audit_collective_matching(_sends(shifts[:-1], n=4), topo).ok
    assert not audit_collective_matching(_sends([1, 7]),
                                         topology.fully_connected(8)).ok


# ---------------------------------------------------------------------------
# the production audits, through the CLI
# ---------------------------------------------------------------------------


def test_production_audits_pass_via_cli_on_the_cpu(tmp_path):
    out_json = tmp_path / "audit.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "audit", "--device",
         "cpu", "--json", str(out_json)],
        env=env, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    results = json.loads(out_json.read_text())
    assert [r["name"] for r in results] == _reference_audit_names()
    assert all(r["ok"] for r in results), results
    by = {r["name"]: r for r in results}
    assert by["donation"]["data"]["leaves"] == 2
    neutral = by["telemetry-neutrality"]["data"]
    assert neutral["bare"] == neutral["instrumented"]
    assert neutral["compile_events"] >= 1
    for name in ("collective-matching", "participation-collectives",
                 "overlap-collectives"):
        data = by[name]["data"]
        # 8 ranks x 2 shifts x 2 gossip steps; the packed [33] f32 row
        # (132 bytes, 16-byte aligned: 144) x 2 shifts x 2 steps
        assert data["num_sends"] == 32 and data["bytes_per_rank"] == 576
        # one count for each (src, dst): 8 ranks x 2 shifts, each sent twice
        assert sorted(c for _, _, c in data["sends"]) == [2] * 16
        assert data["observed"] == data["expected"]
        # the control: the ranks' sends against fully_connected(8)'s pairs
        control = audit_collective_matching(
            {(s, d): c for s, d, c in data["sends"]},
            topology.fully_connected(8))
        assert not control.ok
    for name in ("recompile", "participation-recompile", "overlap-recompile",
                 "cohort-recompile"):
        counts = list(by[name]["data"]["counts"].values())
        assert counts[0]["builds"] == 1 and len(counts) >= 3


def test_audit_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.analysis.__main__ import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["audit"])
