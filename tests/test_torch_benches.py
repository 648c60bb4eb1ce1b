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

The launch benches and the LM example, on the CPU:
  * ``bench_overlap --smoke`` on 8 gloo ranks, one spawn under its own
    time limit, with ``--check``'s conditions but its wall-clock bar
    asserted here: a gossip step's exchanged bytes are the ring's two
    shifts of the packed ``w``, the config gossip-dominated, pipelined
    under additive, the planner's max-form round times equal to the
    roofline prediction (bar 1%; they agree to 1e-9 %), no executor builds
    or captures after its warmup. The CPU's eager local step costs more an
    element than the wire at the default 2 GB/s, so the test models a 20
    MB/s link at the reference's 16,384 floats to stay in the
    gossip-dominated regime (the bench's docstring). ``none_overhead``'s
    2% wall-clock bar is held on the card (``chip_smoke.py`` phase 15),
    as the dispatch measurement's 2x bar is: it reads two runs of one code
    path, and 8 ranks sharing the host's cores with the test run's other
    workers read up to 11% of noise.
  * ``bench_round_overhead --measure reduced_arch --smoke --check``: no
    build or capture on the re-plan; legacy builds twice.
  * ``examples/train_lm.py``'s ``main`` at a narrow width (2 layers, d 32,
    vocab 64, 2 nodes, 3 rounds of tau (2, 2), batch 2 x 8 tokens) against the reference example's
    public-API sequence on the same weights (``convert.params_from_jax``):
    losses to the LM contract's f32 rtol 1e-6 (ROADMAP.md, "The LM zoo");
    a checkpoint is written every ``CKPT_EVERY`` rounds and restores.
"""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_bench_overlap_smoke_on_cpu(tmp_path):
    """The bench on 8 CPU ranks. The modeled link is 2 MB/s, so a gossip
    step (two shifts of 64 KiB) costs 65.5 ms and the (2, 4) schedule is
    gossip-dominated while T_step < 131 ms: beside six busy workers the
    CPU's eager T_step read up to 14.8 ms, above the 13.1 ms that a 20 MB/s
    link allowed. The ranks may take 300 s: beside six busy workers the
    bench's 384 pairs of the overhead reading take it near 140 s."""
    from repro_torch.benchmarks import bench_overlap as bo

    payload = bo.main(["--smoke", "--device", "cpu", "--dim", "16384",
                       "--link-bw", "2e6", "--rounds", "2", "--passes", "4",
                       "--timeout", "300", "--out", str(tmp_path / "bo")])
    assert json.loads((tmp_path / "bo.json").read_text()) == payload
    m = payload["measured"]
    assert m["shifts"] == 2 and m["packed_bytes_per_shift"] == 16384 * 4
    assert m["wire_bytes_per_gossip_step"] == 2 * 16384 * 4
    assert m["t_gossip_step_s"] == 2 * 16384 * 4 / 2e6
    assert m["t_step_s"] > 1e-6
    assert m["gossip_dominated"]
    dep, plan = payload["deployment"], payload["planner"]
    assert dep["pipelined_s"] < dep["additive_s"]
    assert plan["pipelined_round_s"] < plan["additive_round_s"]
    assert max(plan["err_vs_roofline_pct"].values()) < 1e-9
    assert payload["zero_recompiles"]
    assert payload["builds_captures"]["after"] == \
        payload["builds_captures"]["warm"]
    assert payload["none_overhead"]["pairs"] == bo.NONE_OVERHEAD_PAIRS
    assert payload["pipeline_wall"]["pairs"] == 4
    assert bo.PLANNER_TOL_PCT == 1.0 and bo.N == 8


def test_reduced_arch_smoke_check_on_cpu(tmp_path):
    from repro_torch.benchmarks import bench_round_overhead as bro

    out = bro.main(["--measure", "reduced_arch", "--smoke", "--check",
                    "--nodes", "4", "--rounds", "4", "--superstep", "2",
                    "--device", "cpu", "--out", str(tmp_path / "ra")])
    ra = out["reduced_arch"]
    assert out["zero_recompile_replan"]
    assert ra["executor_round"]["builds_after_warmup"] == 0
    assert ra["executor_superstep"]["builds_after_warmup"] == 0
    assert ra["legacy"]["builds"] == 2          # the first, the re-plan's
    cfg = out["config"]
    assert (cfg["nodes"], cfg["schedule"], cfg["replan_round"],
            cfg["seq"]) == (4, [[2, 2], [4, 1]], 2, 8)
    assert json.loads((tmp_path / "ra.json").read_text())["config"] == cfg


def test_train_lm_equals_reference_sequence(tmp_path, monkeypatch):
    import jax

    from repro.core import init_state as jinit_state
    from repro.core import make_round_fn as jmake_round_fn
    from repro.data.lm import SyntheticLM as JSyntheticLM
    from repro.data.lm import lm_batches_for_dfl as jlm_batches_for_dfl
    from repro.models import ModelConfig as JModelConfig
    from repro.models import init_params as jinit_params
    from repro.models import train_loss as jtrain_loss
    from repro.optim import adamw as jadamw
    from repro.optim import warmup_cosine as jwarmup_cosine
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.convert import params_from_jax
    from repro_torch.examples import train_lm
    from repro_torch.models import ModelConfig

    kw = dict(name="qwen3-narrow", arch_type="dense", num_layers=2,
              d_model=32, num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
              vocab_size=64, qk_norm=True, attn_q_chunk=8, attn_kv_chunk=8,
              loss_seq_chunk=8, remat=False)
    jcfg = JModelConfig(dtype=jnp.float32, **kw)
    nodes, tau1, tau2, batch, seq, rounds = 2, 2, 2, 2, 8, 3
    # the reference example's sequence, at this width
    params, _ = jinit_params(jcfg, jax.random.key(0))
    total = rounds * tau1
    opt = jadamw(jwarmup_cosine(3e-4, warmup_steps=total // 20,
                                total_steps=total))
    corpus = JSyntheticLM(vocab_size=jcfg.vocab_size, num_nodes=nodes,
                          noniid_alpha=0.5, branching=8)
    state = jinit_state(params, nodes, opt, jax.random.key(1))
    round_fn = jax.jit(jmake_round_fn(
        JDFLConfig(tau1=tau1, tau2=tau2, topology=jring(nodes)),
        lambda p, b, k: jtrain_loss(p, b, jcfg, k), opt))
    want = []
    for r in range(rounds):
        state, m = round_fn(state, jlm_batches_for_dfl(
            corpus, tau1, nodes, batch, seq, r))
        want.append(float(m["loss"]))

    monkeypatch.setattr(train_lm, "CKPT_EVERY", 2)
    lines = []
    rec = train_lm.main(
        ["--rounds", str(rounds), "--nodes", str(nodes), "--tau1", str(tau1),
         "--tau2", str(tau2), "--batch", str(batch), "--seq", str(seq),
         "--ckpt", str(tmp_path)],
        ModelConfig(dtype=torch.float32, **kw), device="cpu",
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               "cpu"),
        log=lines.append)
    np.testing.assert_allclose(rec["losses"], want, rtol=1e-6)
    assert lines[0].startswith("model: qwen3-narrow")
    assert lines[1].startswith("round    1/3 loss=")
    got = rec["state"].params
    restored, step = restore_checkpoint(str(tmp_path), got)
    assert step == 2 and set(restored) == set(got)
    assert train_lm.CFG.num_layers == 12 and train_lm.CFG.d_model == 768
    assert train_lm.CFG.vocab_size == 32768
