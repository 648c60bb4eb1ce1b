"""The port's planner benches (``repro_torch.benchmarks.bench_trajectory``,
``bench_balance``, ``run``) against the reference's (``benchmarks/``), on
the CPU.

``bench_trajectory``'s plan is the reference's ``plan_trajectory`` rows bit
for bit, and so is every fixed schedule's round count; its
``run_schedule`` over a short fixed schedule and a short heterogeneous
trajectory lands within 1e-5 of the reference's final loss (the same numpy
noise in the batches; f32 arithmetic on both); ``--smoke --check`` passes
with its JSON in a temporary directory. ``bench_balance`` at 2 rounds
records the reference's planned pick for every ratio.
"""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest

import benchmarks.bench_balance as jbb
import benchmarks.bench_trajectory as jbt
from repro.core import DFLConfig as JDFLConfig
from repro.core import RoundExecutor as JRoundExecutor
from repro.core import ring as jring
from repro.optim import sgd as jsgd
from repro.planner import plan as jplan
from repro.planner import plan_trajectory as jplan_trajectory
from repro.planner import Budget as JBudget
from repro.planner import unit_cost_model as junit_cost_model
from repro_torch.benchmarks import bench_balance as bb
from repro_torch.benchmarks import bench_trajectory as bt
from repro_torch.benchmarks import run as trun
from repro_torch.optim import sgd


def test_trajectory_testbed_and_plan_equal_reference():
    for name in ("N", "DIM", "SIGMA", "TSCALE", "ETA", "GRID", "T_GOSSIP",
                 "SLOWDOWN", "EPISODES", "BUDGET", "SUPERSTEP", "MAX_ROUNDS"):
        assert getattr(bt, name) == getattr(jbt, name), name
    targets = bt.testbed_targets()
    assert targets.tobytes() == (np.random.default_rng(0).normal(
        size=(jbt.N, jbt.DIM)) * jbt.TSCALE).tobytes()
    assert bt.testbed_constants(targets) == jbt.testbed_constants(targets)
    process, jprocess = bt.build_process(), jbt.build_process()
    f_gap, sig_eff = jbt.testbed_constants(targets)
    tp = bt.plan(process, targets)
    want = jplan_trajectory(JBudget(wall_clock_s=jbt.BUDGET), jprocess,
                            rounds=jbt.MAX_ROUNDS, sigma=sig_eff,
                            f_gap=f_gap, grid=jbt.GRID, eta=jbt.ETA)
    assert tp.taus.tobytes() == want.taus.tobytes()
    assert (tp.total_time_s, tp.total_wire_bits, tp.total_energy_j) == (
        want.total_time_s, want.total_wire_bits, want.total_energy_j)
    assert [p.predicted_bound for p in tp.steps] == [
        p.predicted_bound for p in want.steps]
    for t1, t2 in bt.GRID:
        assert bt.fixed_schedule(process, bt.BUDGET, t1, t2) == \
            jbt.fixed_schedule(jprocess, jbt.BUDGET, t1, t2)


@pytest.fixture(scope="module")
def ref_executor():
    def quad_loss(p, b, k=None):
        return 0.5 * jnp.sum((p["w"] - b) ** 2)

    return JRoundExecutor(JDFLConfig(tau1=bt.TAU1_MAX, tau2=bt.TAU2_MAX,
                                     topology=jring(bt.N)), quad_loss,
                          jsgd(bt.ETA))


@pytest.mark.parametrize("kind", ["fixed", "trajectory"])
def test_run_schedule_matches_reference(kind, ref_executor):
    """The port's ``run_schedule`` through its executor against the
    reference's through its own, on the same schedule and seed: final
    mean per-node loss gap within 1e-5."""
    if kind == "fixed":
        taus = [(4, 1)] * 13
    else:
        taus = ([(8, 1)] * 3 + [(1, 0)] * 6 + [(4, 1)] * 4 + [(16, 1)]
                + [(2, 2)] * 3 + [(4, 0)] * 2)
    targets = bt.testbed_targets()
    got = bt.run_schedule(bt.make_executor(), taus, targets, 1, bt.TAU1_MAX,
                          sgd(bt.ETA), "cpu")
    want = jbt.run_schedule(ref_executor, taus, targets, 1, jbt.GRID[5][0],
                            jsgd(jbt.ETA))
    assert got == pytest.approx(want, rel=1e-5)


def test_bench_trajectory_smoke_check_on_cpu(tmp_path):
    out = tmp_path / "bench_trajectory.json"
    payload = bt.main(["--smoke", "--check", "--device", "cpu", "--out",
                       str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(payload))
    assert payload["trajectory_beats_best_fixed"]
    assert payload["builds_after_warmup"] == 0
    assert payload["captures_after_warmup"] == 0
    assert payload["config"]["seeds"] == 2
    assert payload["trajectory"]["rounds"] == len(
        payload["trajectory"]["schedule"])
    assert bt.DEFAULT_OUT.endswith("results/repro_torch/bench_trajectory.json")


def test_bench_balance_planned_picks_equal_reference(tmp_path, capsys):
    rows = bb.run(rounds=2, device="cpu", results_dir=str(tmp_path))
    out = json.loads((tmp_path / "balance_mnist.json").read_text())
    assert bb.GRID == jbb.GRID and bb.RATIOS == jbb.RATIOS
    for ratio in bb.RATIOS:
        cm = junit_cost_model(jring(jbb.NODES), ratio)
        p = jplan(jbb.budget_for(ratio), cm, sigma=1.0, f_gap=1.0,
                  grid=jbb.GRID)
        assert out["planned"][str(ratio)] == {
            "tau1": p.tau1, "tau2": p.tau2, "eta": p.eta,
            "rounds": p.rounds, "predicted_bound": p.predicted_bound}
        assert bb.budget_for(ratio).wall_clock_s == \
            jbb.budget_for(ratio).wall_clock_s
        winner = out["winners"][str(ratio)]
        assert (winner[1], winner[2]) in bb.GRID
    assert len(out["runs"]) == len(bb.GRID)
    assert all(math.isfinite(r["loss_at_budget"]) for r in rows)
    assert "BEST=" in capsys.readouterr().out


def test_run_py_runs_theory(capsys):
    assert {"theory", "balance"} <= set(trun.BENCHES)
    trun.main(["--only", "theory", "--device", "cpu"])
    assert "all bounds hold" in capsys.readouterr().out
