"""The port's planner (``repro_torch.planner``: bounds, optimizer, adaptive
controller) against the reference's (``repro.planner``), and the adaptive
loop that drives the port's executor from it (``launch.planned_run``).

The planner is numpy only in both packages, so the port is held BITWISE:
every bound, ``evaluate_grid`` / ``plan`` / ``plan_trajectory`` over
topologies x compressors x budgets, and both controllers fed one recorded
observation sequence give exactly the reference's floats. The cases of the
reference's ``tests/test_planner.py`` (but its two train-CLI sessions and
``build_planned_round``, which wait for the port's train CLI), the planner
cases of ``tests/test_overlap.py`` and the availability cases of
``tests/test_faults.py`` run against the port with the reference's
assertions. The loop runs the MNIST CNN on the CPU under a small budget.
"""
import ast
import dataclasses
import math
import os
import warnings

import numpy as np
import pytest
import torch

from repro.core import compression as jcompression
from repro.core import topology as jtopology
from repro.planner import adaptive as jadaptive
from repro.planner import bounds as jbounds
from repro.planner import cost as jcost
from repro.planner import optimize as joptimize
from repro_torch import planner as tplanner
from repro_torch.benchmarks.theory_check import run_dfl_quadratic
from repro_torch.core import compression, topology
from repro_torch.core.compression import QSGD, TopK
from repro_torch.core.topology import fully_connected, ring, star
from repro_torch.faults import FaultPlan, NodeCrash
from repro_torch.planner import (AdaptiveController, Budget, ComputeModel,
                                 CostModel, CostProcess, Episode, LinkModel,
                                 WirelessLinks, bounds, edge_outage,
                                 evaluate_grid, faded_links, plan,
                                 plan_trajectory, rounds_within, select_plan,
                                 straggler_links, unit_cost_model,
                                 wireless_link)
from repro_torch.planner import adaptive, cost, optimize

PLANNER_SRC = os.path.join(os.path.dirname(__file__), "..", "src",
                           "repro_torch", "planner")

# -- the quadratic testbed shared by the acceptance tests -------------------

TOPO = ring(8)
SIGMA = 0.5            # sampling-noise sigma of the testbed
TSCALE = 0.8           # target (heterogeneity) scale
REF_ROUNDS = 60        # budget = this many rounds of the (2, 2) schedule
GRID = [(1, 4), (1, 2), (2, 2), (2, 1), (4, 1), (8, 1)]
SEEDS = 4
DIM = 16
N_OVERLAP = 8          # tests/test_overlap.py's ring


def _testbed_constants():
    """f_gap and the Assumption-1.5 sigma (sampling + heterogeneity)."""
    rng = np.random.default_rng(0)
    targets = rng.normal(size=(TOPO.num_nodes, DIM)) * TSCALE
    tbar = targets.mean(0)
    f_gap = 0.5 * float(np.sum(tbar**2))
    sig_eff = np.sqrt(SIGMA**2
                      + float(np.max(np.sum((targets - tbar) ** 2, axis=1))))
    return f_gap, sig_eff


def _measured(eta, tau1, tau2, rounds):
    """Mean measured avg ||grad F(u_t)||^2 — the quantity bound (20)
    bounds — over the testbed seeds."""
    return float(np.mean([
        run_dfl_quadratic(eta, tau1, tau2, TOPO, rounds, d=DIM, sigma=SIGMA,
                          seed=s, target_scale=TSCALE)[0]
        for s in range(SEEDS)]))


def _plan_at(ratio):
    f_gap, sig_eff = _testbed_constants()
    cm = unit_cost_model(TOPO, ratio)
    budget = Budget(wall_clock_s=cm.round_cost(2, 2).time_s * REF_ROUNDS)
    cands = evaluate_grid(budget, cm, sigma=sig_eff, f_gap=f_gap, grid=GRID)
    return select_plan(cands), cands


# -- the package boundary ---------------------------------------------------


def test_planner_exports_and_is_numpy_only():
    """The port exports exactly the reference's names, and no planner module
    imports torch (its numbers are numpy's, as the reference's are)."""
    import repro.planner as jplanner

    assert tplanner.__all__ == jplanner.__all__
    for name in ("bounds", "optimize", "adaptive", "cost"):
        tree = ast.parse(open(os.path.join(PLANNER_SRC, name + ".py")).read())
        mods = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
        mods |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
        assert not mods & {"torch", "jax", "repro"}, (name, mods)
    assert bounds.__all__ == jbounds.__all__
    assert optimize.__all__ == joptimize.__all__
    assert optimize.DEFAULT_GRID == joptimize.DEFAULT_GRID


def test_controller_telemetry_not_ported():
    with pytest.raises(NotImplementedError, match="item 9"):
        AdaptiveController(Budget(wall_clock_s=1.0),
                           unit_cost_model(TOPO, 1.0), sigma=1.0, f_gap=1.0,
                           telemetry=object())


# -- acceptance: the paper's qualitative result end-to-end ------------------


def test_planned_ratio_monotone_in_comm_cost():
    """As t_comm/t_compute rises, planned tau1/tau2 is non-decreasing and
    strictly rises across the sweep (paper Sec. V: slower links shift the
    balance toward local computation)."""
    ratios = [_plan_at(r)[0] for r in (0.2, 1.0, 5.0, 25.0)]
    tau_ratio = [p.tau1 / p.tau2 for p in ratios]
    assert all(a <= b for a, b in zip(tau_ratio, tau_ratio[1:])), tau_ratio
    assert tau_ratio[-1] > tau_ratio[0], tau_ratio


@pytest.mark.parametrize("ratio", [0.2, 25.0])
def test_planned_schedule_wins_empirically(ratio):
    """The planned schedule's measured loss at budget is <= every other
    grid point's, on actual Algorithm-1 runs (not the bound)."""
    p, cands = _plan_at(ratio)
    measured = {(c.tau1, c.tau2): _measured(c.eta, c.tau1, c.tau2, c.rounds)
                for c in cands}
    mine = measured[(p.tau1, p.tau2)]
    assert mine <= min(measured.values()) + 1e-12, (p.tau1, p.tau2, measured)


# -- cost models ------------------------------------------------------------


def test_unit_cost_model_prices_the_ratio():
    cm = unit_cost_model(TOPO, 5.0)
    rc = cm.round_cost(4, 2)
    assert rc.t_compute_step == pytest.approx(1.0)
    assert rc.t_gossip_step == pytest.approx(5.0)
    assert rc.time_s == pytest.approx(4 + 2 * 5.0)
    assert rc.comm_fraction == pytest.approx(10.0 / 14.0)


def test_engine_accounting_dense_vs_sparse():
    """Dense all-gather lowering ships N-1 copies; sparse ships degree."""
    base = dict(compute=ComputeModel(1e9, 1e12),
                link=LinkModel(1e9), topology=ring(10), model_bits=32e6)
    sparse = CostModel(engine="sparse", **base)
    dense = CostModel(engine="dense", **base)
    assert sparse.copies_per_step() == 2
    assert dense.copies_per_step() == 9
    assert (dense.round_cost(1, 1).wire_bits
            == pytest.approx(sparse.round_cost(1, 1).wire_bits * 9 / 2))


def test_compression_reduces_cost():
    cm = unit_cost_model(TOPO, 1.0)
    full = cm.round_cost(2, 4)
    topk = cm.round_cost(2, 4, TopK(frac=0.25))
    qsgd = cm.round_cost(2, 4, QSGD(levels=16))
    assert topk.wire_bits < full.wire_bits
    assert qsgd.wire_bits < full.wire_bits
    assert topk.time_s < full.time_s
    # compute side is untouched by compression
    assert topk.t_compute_step == full.t_compute_step


def test_wireless_links_snr_and_slowest_edge():
    """Lower SNR -> slower link; the slowest edge gates the gossip step."""
    fast = wireless_link(20e6, 30.0)
    slow = wireless_link(20e6, 0.0)
    assert slow.bytes_per_s < fast.bytes_per_s
    topo = ring(6)
    uniform = CostModel(
        compute=ComputeModel(1e9, 1e12),
        link=WirelessLinks(default=fast), topology=topo, model_bits=8e6)
    degraded = CostModel(
        compute=ComputeModel(1e9, 1e12),
        link=WirelessLinks(default=fast, per_edge={(0, 1): slow}),
        topology=topo, model_bits=8e6)
    assert (degraded.t_gossip_step()
            > uniform.t_gossip_step())
    # serial (half-duplex) radios sum per-node transfers
    serial = CostModel(
        compute=ComputeModel(1e9, 1e12),
        link=WirelessLinks(default=fast, concurrency="serial"),
        topology=topo, model_bits=8e6)
    assert serial.t_gossip_step() == pytest.approx(
        2 * uniform.t_gossip_step())


def test_budget_currencies():
    cm = unit_cost_model(TOPO, 1.0)
    rc = cm.round_cost(4, 4)
    assert rounds_within(Budget(wall_clock_s=80.0), rc) == 10
    assert rounds_within(Budget(wire_bits=rc.wire_bits * 3.5), rc) == 3
    # the tightest currency binds
    assert rounds_within(Budget(wall_clock_s=80.0,
                                wire_bits=rc.wire_bits * 3.5), rc) == 3
    with pytest.raises(ValueError):
        Budget()


def test_plan_infeasible_budget_raises():
    cm = unit_cost_model(TOPO, 1.0)
    with pytest.raises(ValueError):
        plan(Budget(wall_clock_s=0.5), cm, sigma=1.0, f_gap=1.0,
             grid=[(4, 4)])


# -- time-varying processes & per-round trajectories ------------------------


def _wireless_unit(t_gossip: float, mod=cost):
    """WirelessLinks pricing one gossip step at ``t_gossip`` units."""
    copy_bytes = 32.0 * DIM / 8.0
    return mod.WirelessLinks(
        default=mod.LinkModel(bytes_per_s=copy_bytes / t_gossip))


def _process(episodes=()):
    base = CostModel(compute=ComputeModel(1.0, 1.0),
                     link=_wireless_unit(1.0), topology=TOPO,
                     model_bits=32.0 * DIM)
    return CostProcess(base=base, episodes=tuple(episodes))


def test_link_helpers_price_per_edge():
    """straggler slows ONLY the touched edges (each exactly once), fading
    slows everything, outage drops named edges to a residual rate."""
    wl = _wireless_unit(1.0)
    strag = straggler_links(wl, TOPO, 0, 10.0)
    assert strag.link(0, 1).bytes_per_s == pytest.approx(
        wl.default.bytes_per_s / 10.0)   # scaled ONCE, not once per side
    assert strag.link(0, 7).bytes_per_s == pytest.approx(
        wl.default.bytes_per_s / 10.0)
    assert strag.link(2, 3).bytes_per_s == wl.default.bytes_per_s
    fade = faded_links(wl, 10.0)
    assert fade.link(2, 3).bytes_per_s == pytest.approx(
        wl.default.bytes_per_s / 10.0)
    out = edge_outage(wl, [(3, 2)], residual=1e-3)
    assert out.link(2, 3).bytes_per_s == pytest.approx(
        wl.default.bytes_per_s * 1e-3)
    assert out.link(0, 1).bytes_per_s == wl.default.bytes_per_s
    # one slow edge gates the whole synchronous gossip step
    cm = CostModel(compute=ComputeModel(1.0, 1.0), link=strag,
                   topology=TOPO, model_bits=32.0 * DIM)
    assert cm.t_gossip_step() == pytest.approx(10.0)


def test_cost_process_episode_windows_and_compute_scale():
    proc = _process([Episode(10.0, 20.0, link=faded_links(
        _wireless_unit(1.0), 50.0), compute_scale=2.0, label="ep")])
    assert not proc.is_static and proc.horizon() == 20.0
    assert proc.at(5.0).t_gossip_step() == pytest.approx(1.0)
    assert proc.at(15.0).t_gossip_step() == pytest.approx(50.0)
    assert proc.at(15.0).compute.t_step == pytest.approx(2.0)
    assert proc.at(20.0).t_gossip_step() == pytest.approx(1.0)  # half-open
    assert _process().is_static


def test_plan_trajectory_degenerates_to_plan_when_time_invariant():
    """A static process yields EXACTLY the fixed plan's schedule,
    repeated."""
    f_gap, sig_eff = _testbed_constants()
    proc = _process()
    budget = Budget(wall_clock_s=proc.base.round_cost(2, 2).time_s
                    * REF_ROUNDS)
    p = plan(budget, proc.base, sigma=sig_eff, f_gap=f_gap, grid=GRID)
    tp = plan_trajectory(budget, proc, rounds=40, sigma=sig_eff,
                         f_gap=f_gap, grid=GRID)
    assert tp.rounds == min(p.rounds, 40)
    assert all((t1, t2) == (p.tau1, p.tau2) for (t1, t2) in tp.taus)
    assert tp.steps[0].eta == p.eta
    assert tp.total_time_s == pytest.approx(
        p.round_cost.time_s * tp.rounds)
    assert tp.tau_maxima == (p.tau1, p.tau2)


def test_plan_trajectory_shifts_through_episodes():
    """During an outage-severity episode the per-round schedule drops
    gossip (tau2-light / compute-only rounds); off-episode it keeps the
    base plan's balance — and the whole trajectory respects the budget on
    the process clock."""
    f_gap, sig_eff = _testbed_constants()
    grid = GRID + [(1, 0), (8, 0)]
    ep_link = straggler_links(_wireless_unit(1.0), TOPO, 0, 1000.0)
    proc = _process([Episode(30.0, 90.0, link=ep_link)])
    budget = Budget(wall_clock_s=150.0)
    tp = plan_trajectory(budget, proc, rounds=500, sigma=sig_eff,
                         f_gap=f_gap, grid=grid)
    assert tp.total_time_s <= 150.0 + 1e-9
    # walk the clock: split rounds into off-episode and in-episode
    clock, in_ep, off_ep = 0.0, [], []
    for p in tp.steps:
        (in_ep if 30.0 <= clock < 90.0 else off_ep).append((p.tau1, p.tau2))
        clock += p.round_cost.time_s
    assert in_ep and off_ep
    # every in-episode round avoids the ruinous gossip entirely
    assert all(t2 == 0 for _, t2 in in_ep), in_ep
    # off-episode rounds gossip (the base tariff makes it worthwhile)
    assert any(t2 >= 1 for _, t2 in off_ep), off_ep


def test_plan_trajectory_infeasible_budget_raises():
    with pytest.raises(ValueError):
        plan_trajectory(Budget(wall_clock_s=0.5), _process(), rounds=10,
                        sigma=1.0, f_gap=1.0, grid=[(4, 4)])


def test_bounds_reject_standing_tau2_zero():
    """tau2 = 0 on a non-complete graph is a never-gossip POLICY: no
    finite bound, no admissible eta — it stays a last-resort trajectory
    grid point via select_plan's tie-break."""
    assert not bounds.lr_condition_19(0.01, 4, 0, TOPO)
    assert bounds.bound_20(0.01, 4, 0, TOPO, 100, 1.0, 1.0, 8) == float("inf")
    ev = bounds.predicted_loss_decrement(4, 0, TOPO, 1.0, T=100, f_gap=1.0)
    assert ev.bound == float("inf")
    # the complete graph is no exception, fully_connected(2) included
    for full in (fully_connected(8), fully_connected(2)):
        assert bounds.predicted_loss_decrement(
            4, 0, full, 1.0, T=100, f_gap=1.0).bound == float("inf")
        assert not bounds.lr_condition_19(0.01, 4, 0, full)
        assert bounds.max_eta_19(4, 0, full) == 0.0
        assert bounds.bound_20(0.01, 4, 0, full, 100, 1.0, 1.0,
                               full.num_nodes) == float("inf")
    # a single node has no consensus to lose: tau2 = 0 stays finite
    assert np.isfinite(bounds.predicted_loss_decrement(
        4, 0, fully_connected(1), 1.0, T=100, f_gap=1.0).bound)


# -- deprecation shim -------------------------------------------------------


def test_metrics_shim_matches_planner_on_docstring_example():
    from repro_torch.core.metrics import comm_compute_cost as old
    from repro_torch.planner.cost import comm_compute_cost as new

    kw = dict(step_flops=1e9, model_bytes=4e6, degree=2, flops_per_s=1e12,
              link_bytes_per_s=1e9)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = old(4, 2, 10, **kw)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    want = new(4, 2, 10, **kw)
    assert got == want
    assert got["t_compute"] == pytest.approx(1e-3)
    assert got["t_comm"] == pytest.approx(8e-3)


# -- bounds library ---------------------------------------------------------


def test_bounds_moved_and_reexported():
    import repro_torch.benchmarks.theory_check as tc

    assert tc.lr_condition_19 is bounds.lr_condition_19
    assert tc.bound_20 is bounds.bound_20
    assert tc.max_eta_19 is bounds.max_eta_19


def test_predicted_loss_decrement_improves_with_iterations():
    a = bounds.predicted_loss_decrement(4, 2, TOPO, 1.0, T=600, f_gap=1.0)
    b = bounds.predicted_loss_decrement(4, 2, TOPO, 1.0, T=60, f_gap=1.0)
    assert np.isfinite(a.bound) and a.bound < b.bound
    assert bounds.lr_condition_19(a.eta, 4, 2, TOPO)
    assert a.bound == pytest.approx(a.opt_term + a.stat_term + a.drift_term)


def test_cdfl_constants():
    topo = ring(8)
    g = bounds.choco_gamma_star(topo, 0.5)
    assert 0.0 < g < 1.0
    c_full = bounds.cdfl_contraction(topo, 0.5)
    c_half = bounds.cdfl_contraction(topo, 0.5, gamma=g / 2)
    assert 0.0 < c_full < 1.0
    assert c_full < c_half < 1.0          # less gamma -> slower consensus
    # uncompressed mixing keeps the exact spectral zeta
    assert bounds.effective_zeta(topo) == pytest.approx(topo.zeta)
    # compression can never mix FASTER than uncompressed
    z_comp = bounds.effective_zeta(topo, delta=0.25)
    assert topo.zeta <= z_comp < 1.0
    # perfect averaging degrades gracefully too
    z_full = bounds.effective_zeta(fully_connected(8), delta=0.25)
    assert 0.0 <= z_full < 1.0


def test_plan_with_compression_candidates():
    """With an expensive link, a compressed candidate can buy more rounds;
    the chosen plan must at least not be worse in predicted bound than the
    best uncompressed candidate."""
    f_gap, sig_eff = _testbed_constants()
    cm = unit_cost_model(TOPO, 25.0)
    budget = Budget(wall_clock_s=cm.round_cost(2, 2).time_s * REF_ROUNDS)
    p_plain = plan(budget, cm, sigma=sig_eff, f_gap=f_gap, grid=GRID)
    p_comp = plan(budget, cm, sigma=sig_eff, f_gap=f_gap, grid=GRID,
                  compressors=(None, QSGD(levels=16)))
    assert p_comp.predicted_bound <= p_plain.predicted_bound
    assert p_comp.compressor_name in ("none", "qsgd")


def test_non_circulant_topology_priced():
    """Cost model works for any topology (star has degree N-1 hub)."""
    cm = CostModel(compute=ComputeModel(1e9, 1e12), link=LinkModel(1e9),
                   topology=star(8), model_bits=32e6, engine="sparse")
    assert cm.copies_per_step() == 7  # the hub's degree gates accounting


# -- adaptive controller ----------------------------------------------------


def _controller(ratio_prior, budget_s, replan_every=5):
    cm = unit_cost_model(TOPO, ratio_prior)
    f_gap, sig_eff = _testbed_constants()
    return AdaptiveController(
        Budget(wall_clock_s=budget_s), cm, sigma=sig_eff, f_gap=f_gap,
        replan_every=replan_every, grid=GRID)


def test_adaptive_refits_and_replans_to_true_costs():
    """Prior says comm is cheap; measurements reveal comm 25x compute.
    After replanning the controller must shift to a tau1-heavier schedule
    and its fitted per-step times must match the true ones."""
    t_step, t_gossip = 1.0, 25.0
    ctrl = _controller(ratio_prior=0.2, budget_s=(2 + 2 * 25.0) * REF_ROUNDS)
    p0 = ctrl.initial_plan()
    rng = np.random.default_rng(0)
    tau1, tau2 = p0.tau1, p0.tau2
    for r in range(1, 16):
        seconds = (tau1 * t_step + tau2 * t_gossip
                   * (1 + 0.01 * rng.standard_normal()))
        ctrl.observe(tau1, tau2, seconds)
        new = ctrl.maybe_replan(r)
        if new is not None:
            tau1, tau2 = new.tau1, new.tau2
    assert not ctrl.exhausted
    last = ctrl.current
    assert (last.tau1 / last.tau2) > (p0.tau1 / p0.tau2)
    fitted = ctrl.fitted_cost_model()
    assert fitted.compute.t_step == pytest.approx(t_step, rel=0.2)
    assert fitted.t_gossip_step(None) == pytest.approx(t_gossip, rel=0.2)
    assert ctrl.history[0]["cause"] == "initial"
    assert any(h["cause"] == "replan" for h in ctrl.history)
    assert all({"round", "tau1", "tau2", "predicted_bound"} <= set(h)
               for h in ctrl.history)


def test_observe_fits_every_round_and_deprecates_fit_kwarg():
    """observe() enters EVERY measured round into the cost fit, and the old
    ``fit=`` escape hatch is a deprecation shim that is ignored."""
    ctrl = _controller(ratio_prior=1.0, budget_s=1e6)
    ctrl.initial_plan()
    t1, t2 = ctrl.current.tau1, ctrl.current.tau2
    ctrl.observe(t1, t2, 1.0)
    assert len(ctrl.observations) == 1
    with pytest.warns(DeprecationWarning, match="fit"):
        ctrl.observe(t1, t2, 1.0, fit=False)   # ignored: still fitted
    with pytest.warns(DeprecationWarning, match="fit"):
        ctrl.observe(t1, t2, 1.0, fit=True)
    assert len(ctrl.observations) == 3
    assert ctrl.spent_s == pytest.approx(3.0)


def test_adaptive_rank_deficient_fallback_scales_prior():
    """With all observations at one schedule the 2-unknown fit is rank-1:
    the controller scales the prior uniformly instead of diverging."""
    ctrl = _controller(ratio_prior=1.0, budget_s=1e6)
    ctrl.initial_plan()
    t1, t2 = ctrl.current.tau1, ctrl.current.tau2
    prior_round = t1 * 1.0 + t2 * 1.0
    for _ in range(6):
        ctrl.observe(t1, t2, 10.0 * prior_round)   # 10x slower than prior
    fitted = ctrl.fitted_cost_model()
    assert fitted.compute.t_step == pytest.approx(10.0, rel=1e-6)
    assert fitted.t_gossip_step(None) == pytest.approx(10.0, rel=1e-6)


def test_adaptive_probes_rank_deficient_fit_then_replans():
    """All history at one schedule -> the boundary emits a PROBE instead of
    re-planning off the unidentifiable scaled fit; once the probe's rounds
    are measured the next boundary is a real re-plan off a rank-2 fit."""
    ctrl = _controller(ratio_prior=0.2, budget_s=1e5, replan_every=3)
    p = ctrl.initial_plan()
    t_step, t_gossip = 1.0, 25.0
    rows = np.array([[p.tau1, p.tau2]], dtype=float)
    for r in range(1, 4):
        ctrl.observe(p.tau1, p.tau2, p.tau1 * t_step + p.tau2 * t_gossip)
    probe = ctrl.maybe_replan(3)
    assert probe is not None
    assert ctrl.history[-1]["cause"] == "probe"
    rows = np.vstack([rows, [probe.tau1, probe.tau2]])
    assert np.linalg.matrix_rank(rows) == 2
    for r in range(4, 7):
        ctrl.observe(probe.tau1, probe.tau2,
                     probe.tau1 * t_step + probe.tau2 * t_gossip)
    assert ctrl.fit_rank() == 2
    ctrl.maybe_replan(6)
    assert ctrl.history[-1]["cause"] == "replan"
    fitted = ctrl.fitted_cost_model()
    assert fitted.compute.t_step == pytest.approx(t_step, rel=1e-3)
    assert fitted.t_gossip_step(None) == pytest.approx(t_gossip, rel=1e-3)


def test_next_trajectory_uniform_chunk_and_probe_ride():
    """Without a process the emitted chunk is the fitted plan's schedule
    uniformly — except a probe riding the LAST round when the fit is
    rank-deficient; the trajectory event lands in the history."""
    ctrl = _controller(ratio_prior=1.0, budget_s=1e5)
    p = ctrl.initial_plan()
    taus = ctrl.next_trajectory(4)
    assert taus.shape == (4, 2)
    assert all((t1, t2) == (p.tau1, p.tau2) for (t1, t2) in taus)
    for (t1, t2) in taus:
        ctrl.observe(int(t1), int(t2), 5.0)
    taus2 = ctrl.next_trajectory(4, round_idx=4)
    assert taus2 is not None and ctrl.fit_rank() < 2
    probe = taus2[-1]
    assert np.linalg.matrix_rank(
        np.vstack([ctrl._obs_rows(), probe[None].astype(float)])) == 2
    ev = ctrl.history[-1]
    assert ev["cause"] == "trajectory"
    assert ev["probe"] == [int(probe[0]), int(probe[1])]
    assert len(ev["schedule"]) == 4


def test_next_trajectory_with_known_process_routes_around_episode():
    """A controller given a KNOWN episode process emits heterogeneous
    chunks: the episode rounds drop gossip while off-episode rounds keep
    it (re-planning INSIDE the superstep)."""
    f_gap, sig_eff = _testbed_constants()
    grid = GRID + [(1, 0), (8, 0)]
    copy_bytes = 32.0 * DIM / 8.0
    wl = WirelessLinks(default=LinkModel(bytes_per_s=copy_bytes))
    base = CostModel(compute=ComputeModel(1.0, 1.0), link=wl,
                     topology=TOPO, model_bits=32.0 * DIM)
    proc = CostProcess(base=base, episodes=(
        Episode(6.0, 200.0, link=straggler_links(wl, TOPO, 0, 1000.0)),))
    ctrl = AdaptiveController(Budget(wall_clock_s=300.0), base,
                              sigma=sig_eff, f_gap=f_gap, grid=grid,
                              process=proc)
    ctrl.initial_plan()
    taus = ctrl.next_trajectory(12)
    assert taus is not None
    assert taus[0][1] >= 1, taus
    assert any(t2 == 0 for _, t2 in taus), taus


def test_observe_chunk_aggregates_heterogeneous_supersteps():
    """observe_chunk enters ONE (sum tau1, sum tau2) fit row, so mixed-
    schedule chunks (probe included) identify the true per-step times
    exactly."""
    t_step, t_gossip = 1.0, 25.0
    ctrl = _controller(ratio_prior=1.0, budget_s=1e6)
    ctrl.initial_plan()

    def chunk_seconds(taus):
        return sum(t1 * t_step + t2 * t_gossip for (t1, t2) in taus)

    uniform = [(4, 1)] * 5
    with_probe = [(4, 1)] * 4 + [(1, 4)]
    ctrl.observe_chunk(uniform, chunk_seconds(uniform))
    assert ctrl.fit_rank() == 1 and len(ctrl.observations) == 1
    assert ctrl.observations[0].tau1 == 20 and ctrl.observations[0].tau2 == 5
    ctrl.observe_chunk(with_probe, chunk_seconds(with_probe))
    assert ctrl.fit_rank() == 2
    fitted = ctrl.fitted_cost_model()
    assert fitted.compute.t_step == pytest.approx(t_step, rel=1e-6)
    assert fitted.t_gossip_step(None) == pytest.approx(t_gossip, rel=1e-6)
    assert ctrl.spent_s == pytest.approx(chunk_seconds(uniform)
                                         + chunk_seconds(with_probe))


def test_next_trajectory_probe_skipped_when_unaffordable():
    """A rank-raising probe that would blow the remaining budget is
    dropped (the chunk keeps its planned schedule)."""
    cm = unit_cost_model(TOPO, 100.0)   # gossip brutally expensive
    f_gap, sig_eff = _testbed_constants()
    ctrl = AdaptiveController(Budget(wall_clock_s=250.0), cm,
                              sigma=sig_eff, f_gap=f_gap,
                              grid=[(1, 0), (2, 0), (8, 1)])
    ctrl.initial_plan()
    p = ctrl.current
    for _ in range(3):
        ctrl.observe(p.tau1, p.tau2, 1.0)
    taus = ctrl.next_trajectory(4, round_idx=3)
    assert taus is not None
    ev = ctrl.history[-1]
    if ev["probe"] is not None:   # probe only rides when it fits
        t1, t2 = ev["probe"]
        rc = ctrl.cost_model.round_cost(t1, t2)
        assert rc.time_s <= 250.0 - ctrl.spent_s


@pytest.mark.parametrize("what", ["next_trajectory", "budget", "energy"])
def test_adaptive_exhaustion(what):
    """The controller stops once the remainder cannot fund another planned
    round: a blown wall-clock budget ends ``next_trajectory``, per-round
    observation spends it down, and an energy-only budget is spent down
    analytically (the fitted model keeps the energy prices)."""
    if what == "next_trajectory":
        ctrl = _controller(ratio_prior=1.0, budget_s=10.0)
        p = ctrl.initial_plan()
        ctrl.observe(p.tau1, p.tau2, 50.0)   # blow the whole budget
        assert ctrl.next_trajectory(4, round_idx=1) is None
        assert ctrl.exhausted
    elif what == "budget":
        ctrl = _controller(ratio_prior=1.0, budget_s=100.0, replan_every=1)
        p = ctrl.initial_plan()
        spent, r = 0.0, 0
        while not ctrl.exhausted and r < 1000:
            r += 1
            ctrl.observe(p.tau1, p.tau2, 30.0)
            spent += 30.0
            ctrl.maybe_replan(r)
        assert ctrl.exhausted and r < 1000
        assert 100.0 - 30.0 <= spent <= 100.0 + 30.0
    else:
        f_gap, sig_eff = _testbed_constants()
        cm = CostModel(
            compute=ComputeModel(step_flops=1.0, flops_per_s=1.0,
                                 joules_per_flop=2.0),
            link=LinkModel(bytes_per_s=1.0, joules_per_byte=0.5),
            topology=TOPO, model_bits=80.0)
        per_round = {(t1, t2): cm.round_cost(t1, t2).energy_j
                     for t1, t2 in GRID}
        budget_j = 40.0 * min(per_round.values())
        ctrl = AdaptiveController(Budget(energy_j=budget_j), cm,
                                  sigma=sig_eff, f_gap=f_gap, grid=GRID,
                                  replan_every=1)
        p = ctrl.initial_plan()
        r = 0
        while not ctrl.exhausted and r < 500:
            r += 1
            ctrl.observe(p.tau1, p.tau2, 1.0)
            p = ctrl.maybe_replan(r) or p
        assert ctrl.exhausted and r < 500
        assert ctrl.spent_j <= budget_j + max(per_round.values())
        assert ctrl.spent_j >= budget_j - max(per_round.values())
        assert ctrl.fitted_cost_model().round_cost(2, 2).energy_j > 0.0


# -- the planner cases of tests/test_overlap.py -----------------------------


def test_stale_mixing_zeta():
    topo = ring(N_OVERLAP)
    z0 = bounds.stale_mixing_zeta(topo, 0.0)
    assert z0 == pytest.approx(bounds.sporadic_zeta(topo, 1.0))
    z1 = bounds.stale_mixing_zeta(topo, 1.0)
    z3 = bounds.stale_mixing_zeta(topo, 3.0)
    assert z0 < z1 < z3 < 1.0
    with pytest.raises(ValueError, match="staleness"):
        bounds.stale_mixing_zeta(topo, -0.5)


def test_staleness_penalizes_loss_decrement():
    kw = dict(T=200, f_gap=1.0)
    fresh = bounds.predicted_loss_decrement(4, 2, ring(N_OVERLAP), 0.5, **kw)
    stale = bounds.predicted_loss_decrement(4, 2, ring(N_OVERLAP), 0.5,
                                            staleness=1.0, **kw)
    assert stale.zeta > fresh.zeta
    assert stale.bound >= fresh.bound


def test_pipeline_plan_shifts_toward_compute():
    """On a gossip-dominated link the pipelined planner picks a schedule
    at least as tau1-heavy as the additive one."""
    topo = ring(N_OVERLAP)
    grid = [(1, 4), (1, 2), (1, 1), (2, 2), (2, 1), (4, 1), (8, 1)]
    sigma, f_gap = 0.5, 1.0
    cm_none = unit_cost_model(topo, 4.0)
    cm_pipe = unit_cost_model(topo, 4.0, overlap="pipeline")
    budget = Budget(wall_clock_s=cm_none.round_cost(2, 2).time_s * 60)
    p_none = select_plan(evaluate_grid(budget, cm_none, sigma=sigma,
                                       f_gap=f_gap, grid=grid))
    p_pipe = select_plan(evaluate_grid(budget, cm_pipe, sigma=sigma,
                                       f_gap=f_gap, grid=grid))

    def ratio(p):
        return p.tau1 / max(p.tau2, 1)

    assert ratio(p_pipe) >= ratio(p_none)
    assert (cm_pipe.round_cost(p_pipe.tau1, p_pipe.tau2).time_s
            <= cm_none.round_cost(p_pipe.tau1, p_pipe.tau2).time_s)


def test_fitted_cost_model_preserves_overlap():
    cm = unit_cost_model(ring(N_OVERLAP), 1.0, overlap="pipeline")
    ctrl = AdaptiveController(Budget(wall_clock_s=1e6), cm, sigma=0.5,
                              f_gap=1.0, grid=[(2, 2), (4, 1)])
    ctrl.initial_plan()
    ctrl.observe(2, 2, 1.0)
    ctrl.observe(4, 1, 1.3)
    assert ctrl.fitted_cost_model().overlap == "pipeline"


def test_predict_trajectory_matches_next_trajectory():
    """After observe_chunk and before new spend, predict_trajectory returns
    exactly what next_trajectory will emit — and mutates nothing."""
    cm = unit_cost_model(ring(N_OVERLAP), 1.0)
    ctrl = AdaptiveController(Budget(wall_clock_s=1e5), cm, sigma=0.5,
                              f_gap=1.0, grid=[(1, 1), (2, 2), (4, 1)])
    ctrl.initial_plan()
    n_hist = len(ctrl.history)
    pred = ctrl.predict_trajectory(4)
    assert pred is not None
    np.testing.assert_array_equal(pred, ctrl.predict_trajectory(4))
    assert len(ctrl.history) == n_hist
    taus = ctrl.next_trajectory(4)
    np.testing.assert_array_equal(pred, taus)
    assert len(ctrl.history) == n_hist + 1
    ctrl.observe_chunk([(int(a), int(b)) for a, b in taus], 12.0)
    pred = ctrl.predict_trajectory(4)
    np.testing.assert_array_equal(pred, ctrl.next_trajectory(4, round_idx=4))


def test_predict_trajectory_exhaustion_returns_none():
    cm = unit_cost_model(ring(N_OVERLAP), 1.0)
    ctrl = AdaptiveController(Budget(wall_clock_s=5.0), cm, sigma=0.5,
                              f_gap=1.0, grid=[(2, 2)])
    ctrl.initial_plan()
    ctrl.observe_chunk([(2, 2)] * 4, 100.0)          # budget gone
    assert ctrl.predict_trajectory(4) is None
    assert not ctrl.exhausted                        # prediction never sets it
    assert ctrl.next_trajectory(4, round_idx=4) is None
    assert ctrl.exhausted


# -- the planning cases of tests/test_faults.py -----------------------------


def test_availability_bound_degenerates_and_prices_sporadic():
    topo = ring(8)
    kw = dict(topology=topo, sigma=0.5, T=200, f_gap=1.0)
    pld, avail = bounds.predicted_loss_decrement, bounds.Availability
    legacy = pld(4, 2, **kw)
    assert legacy == pld(4, 2, availability=avail(), **kw)
    degraded = pld(4, 2, availability=avail(node_rate=0.6, edge_rate=0.5),
                   **kw)
    assert degraded.bound > legacy.bound
    outage = pld(4, 0, availability=avail(edge_rate=0.9, resume_tau2=2.0),
                 **kw)
    assert np.isfinite(outage.bound)
    slower_resume = pld(
        4, 0, availability=avail(edge_rate=0.9, resume_tau2=0.5), **kw)
    assert slower_resume.bound > outage.bound
    assert pld(4, 0, availability=avail(resume_tau2=2.0),
               **kw).bound == float("inf")
    for rate in (0.0, 0.3, 1.0):
        em = bounds.expected_mixing(topo, rate)
        assert np.allclose(em.sum(0), 1.0) and np.allclose(em, em.T)
    assert bounds.sporadic_zeta(topo, 1.0) == pytest.approx(
        topology.zeta(topo.mixing))
    assert bounds.sporadic_zeta(topo, 0.0) == pytest.approx(1.0)


def test_controller_estimates_availability_from_masks():
    topo = ring(4)

    def ctl():
        return AdaptiveController(
            Budget(wall_clock_s=50.0),
            unit_cost_model(topo, 1.0, engine="dense", rep_dim=8),
            sigma=0.5, f_gap=1.0)

    c = ctl()
    assert c.availability() is None
    fplan = FaultPlan(topo, (NodeCrash(node=1, r_start=0, r_stop=2),))
    for r in range(4):
        c.observe_participation(*fplan.masks(r))
    avail = c.availability()
    assert isinstance(avail, bounds.Availability)
    assert avail.node_rate == pytest.approx((3 + 3 + 4 + 4) / 16)
    assert avail.edge_rate < 1.0
    c2 = ctl()
    c2.observe_participation(np.ones(4, np.int32), np.ones(4, np.int32))
    assert c2.availability() is None


# -- bitwise parity with the reference --------------------------------------

TOPOLOGIES = {"ring8": ("ring", (8,)), "torus": ("torus", (2, 4)),
              "quasi": ("paper_quasi_ring", ()),
              "full5": ("fully_connected", (5,))}
COMPRESSORS = {"none": None, "top_k": ("top_k", {"frac": 0.3}),
               "qsgd": ("qsgd", {"levels": 16}),
               "rand_k": ("rand_k", {"frac": 0.5}),
               "rand_gossip": ("rand_gossip", {"p": 0.7})}


def topos(name):
    fn, args = TOPOLOGIES[name]
    return getattr(topology, fn)(*args), getattr(jtopology, fn)(*args)


def comps(name):
    spec = COMPRESSORS[name]
    if spec is None:
        return None, None
    return (compression.make_compressor(spec[0], **spec[1]),
            jcompression.make_compressor(spec[0], **spec[1]))


def outcome(fn, *args, **kwargs):
    """``fn``'s result, or the type of the exception it raised."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # the reference's own failures, held alike
        return type(e).__name__


def same(a, b) -> bool:
    """Bitwise equality of floats (NaN and inf included), recursively over
    the containers and dataclasses the planner returns; compressors by
    name."""
    if isinstance(a, (compression.Compressor, jcompression.Compressor)):
        return a.name == b.name
    if a is None or b is None:
        return a is b
    if dataclasses.is_dataclass(a):
        return all(same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, float) or isinstance(b, float):
        return (np.float64(a).tobytes() == np.float64(b).tobytes())
    return a == b


def models(topo_name, overlap="none"):
    """The same cost model from either package: a wireless link table with
    one slow edge, real compute and energy prices."""
    t, jt = topos(topo_name)
    out = []
    for mod, tp in ((cost, t), (jcost, jt)):
        edges = tp.edges()
        link = mod.WirelessLinks(
            default=mod.LinkModel(bytes_per_s=2.5e6, latency_s=1e-3,
                                  joules_per_byte=3e-9),
            per_edge={edges[0]: mod.wireless_link(2e6, 12.0)})
        out.append(mod.CostModel(
            compute=mod.ComputeModel(step_flops=3e9, flops_per_s=2e12,
                                     joules_per_flop=1e-11),
            link=link, topology=tp, model_bits=32.0 * 57678,
            engine="sparse", overlap=overlap))
    return out


BUDGETS = {"wall": dict(wall_clock_s=2.0), "bits": dict(wire_bits=5e8),
           "energy_wall": dict(energy_j=0.5, wall_clock_s=3.0)}


@pytest.mark.parametrize("comp", list(COMPRESSORS))
@pytest.mark.parametrize("topo_name", list(TOPOLOGIES))
def test_grid_plan_and_trajectory_equal_reference(topo_name, comp):
    """``evaluate_grid``, ``plan`` and ``plan_trajectory`` (static and with
    straggler / fade episodes) are the reference's, bit for bit, over every
    budget currency, with and without an availability and the pipelined
    overlap's staleness."""
    c, jc = comps(comp)
    grid = optimize.DEFAULT_GRID + ((1, 0), (4, 0))
    kw = dict(sigma=0.7, f_gap=1.3, grid=grid, gamma=0.6,
              compressors=(None, c) if c else (None,))
    jkw = dict(kw, compressors=(None, jc) if jc else (None,))
    for overlap, bname, avail in (
            ("none", "wall", None), ("none", "bits", None),
            ("none", "energy_wall", None), ("none", "wall", (0.8, 0.6, 2.0)),
            ("pipeline", "wall", None)):
        cm, jcm = models(topo_name, overlap)
        bkw = BUDGETS[bname]
        a = ja = None
        if avail:
            a, ja = bounds.Availability(*avail), jbounds.Availability(*avail)
        got = optimize.evaluate_grid(optimize.Budget(**bkw), cm,
                                     availability=a, **kw)
        want = joptimize.evaluate_grid(joptimize.Budget(**bkw), jcm,
                                       availability=ja, **jkw)
        assert want and same(got, want), (overlap, bname, avail)
        assert same(optimize.select_plan(got), joptimize.select_plan(want))
    assert same(optimize.plan(optimize.Budget(**bkw), cm, **kw),
                joptimize.plan(joptimize.Budget(**bkw), jcm, **jkw))
    for overlap in ("none", "pipeline"):
        cm, jcm = models(topo_name, overlap)
        wl, jwl = cm.link, jcm.link
        episodes = (cost.Episode(0.05, 0.4, link=cost.straggler_links(
            wl, cm.topology, 0, 50.0), label="straggler"),
            cost.Episode(0.6, 0.9, link=cost.faded_links(wl, 20.0),
                         compute_scale=1.5))
        jepisodes = (jcost.Episode(0.05, 0.4, link=jcost.straggler_links(
            jwl, jcm.topology, 0, 50.0), label="straggler"),
            jcost.Episode(0.6, 0.9, link=jcost.faded_links(jwl, 20.0),
                          compute_scale=1.5))
        for eps, jeps in (((), ()), (episodes, jepisodes)):
            kw = dict(rounds=40, sigma=0.7, f_gap=1.3, grid=grid,
                      compressors=(c,), t0=0.01)
            got = optimize.plan_trajectory(
                optimize.Budget(wall_clock_s=1.5),
                cost.CostProcess(base=cm, episodes=eps), **kw)
            want = joptimize.plan_trajectory(
                joptimize.Budget(wall_clock_s=1.5),
                jcost.CostProcess(base=jcm, episodes=jeps),
                **dict(kw, compressors=(jc,)))
            assert same(got, want) and same(got.taus, want.taus)
            assert got.tau_maxima == want.tau_maxima


BOUND_ARGS = [(1, 1), (4, 2), (8, 1), (16, 8), (4, 0), (2, 4)]


@pytest.mark.parametrize("topo_name", list(TOPOLOGIES) + ["ring2", "one"])
def test_bounds_equal_reference(topo_name):
    """Every bound of ``planner.bounds`` is the reference's, bit for bit."""
    if topo_name == "ring2":
        t, jt = fully_connected(2), jtopology.fully_connected(2)
    elif topo_name == "one":
        t, jt = fully_connected(1), jtopology.fully_connected(1)
    else:
        t, jt = topos(topo_name)
    n = t.num_nodes
    for tau1, tau2 in BOUND_ARGS:
        for zeta in (None, 0.0, 0.5, 0.97):
            assert same(bounds.max_eta_19(tau1, tau2, t, 1.3, zeta=zeta),
                        jbounds.max_eta_19(tau1, tau2, jt, 1.3, zeta=zeta))
            for eta in (1e-3, 0.05, 0.4):
                assert same(
                    bounds.lr_condition_19(eta, tau1, tau2, t, 1.3,
                                           zeta=zeta),
                    jbounds.lr_condition_19(eta, tau1, tau2, jt, 1.3,
                                            zeta=zeta))
                assert same(
                    outcome(bounds.bound_20, eta, tau1, tau2, t, 900, 1.1,
                            0.8, n, 1.3, zeta=zeta),
                    outcome(jbounds.bound_20, eta, tau1, tau2, jt, 900, 1.1,
                            0.8, n, 1.3, zeta=zeta))
        for comp in COMPRESSORS:
            c, jc = comps(comp)
            for extra in (dict(), dict(eta=0.02), dict(eta=0.0),
                          dict(staleness=1.0), dict(n=3, L=2.0),
                          dict(availability=(0.7, 0.5, 2.0)),
                          dict(availability=(1.0, 0.9, 0.0))):
                kw = dict(T=700, f_gap=1.2, compressor=c, gamma=0.4,
                          model_dim=4096, **extra)
                jkw = dict(kw, compressor=jc)
                if "availability" in extra:
                    kw["availability"] = bounds.Availability(*extra[
                        "availability"])
                    jkw["availability"] = jbounds.Availability(*extra[
                        "availability"])
                assert same(
                    outcome(bounds.predicted_loss_decrement, tau1, tau2, t,
                            0.9, **kw),
                    outcome(jbounds.predicted_loss_decrement, tau1, tau2,
                            jt, 0.9, **jkw)), (comp, extra)
    for delta in (0.01, 0.25, 1.0):
        for gamma in (None, 0.05, 0.6):
            assert same(bounds.cdfl_contraction(t, delta, gamma),
                        jbounds.cdfl_contraction(jt, delta, gamma))
            assert same(bounds.effective_zeta(t, delta, gamma),
                        jbounds.effective_zeta(jt, delta, gamma))
        assert same(bounds.choco_gamma_star(t, delta),
                    jbounds.choco_gamma_star(jt, delta))
    for rate in (0.0, 0.25, 0.6, 1.0):
        assert same(bounds.expected_mixing(t, rate),
                    jbounds.expected_mixing(jt, rate))
        assert same(bounds.sporadic_zeta(t, rate),
                    jbounds.sporadic_zeta(jt, rate))
    for s in (0.0, 1.0, 3.0):
        assert same(bounds.stale_mixing_zeta(t, s),
                    jbounds.stale_mixing_zeta(jt, s))
    assert same(bounds.sampling_availability(1000, 250, resume_tau2=2.0),
                jbounds.sampling_availability(1000, 250, resume_tau2=2.0))


def _recorded_session(mod, cmod, topo, comp, process):
    """One controller session fed a recorded observation sequence: seconds
    like the card's on the CIFAR CNN (a local step 2.5 ms, a gossip step
    about 1/50 of it, 2% noise), per-round and per-chunk observations, a
    fault plan's participation and overhead spend. Returns everything it
    emitted."""
    model_bits = 32.0 * 576778
    prior = cmod.unit_cost_model(topo, 1.0, rep_dim=int(model_bits // 32))
    base = None
    if process:
        base = cmod.CostProcess(base=prior, episodes=(cmod.Episode(
            1.0, 1.2, link=cmod.faded_links(prior.link, 40.0)),))
    ctrl = mod.AdaptiveController(
        mod.Budget(wall_clock_s=2.0), prior, sigma=1.0, f_gap=1.0,
        compressors=(comp,), replan_every=3, process=base,
        grid=None if process is None else joptimize.DEFAULT_GRID
        + ((1, 0),))
    rng = np.random.default_rng(7)
    t_step, t_gossip = 2.5e-3, 5e-5
    out = [ctrl.initial_plan()]
    masks = FaultPlan(ring(topo.num_nodes),
                      (NodeCrash(node=2, r_start=3, r_stop=9),), seed=0)
    r = 0
    while not ctrl.exhausted and r < 120:
        if r % 10 == 4:                       # a per-round session phase
            p = ctrl.current
            noise = 1 + 0.02 * rng.standard_normal()
            ctrl.observe(p.tau1, p.tau2,
                         (p.tau1 * t_step + p.tau2 * t_gossip) * noise)
            out.append(ctrl.maybe_replan(r + 1))
            r += 1
            continue
        out.append(ctrl.predict_trajectory(4))
        taus = ctrl.next_trajectory(4, round_idx=r)
        out.append(taus)
        if taus is None:
            break
        ctrl.spend_overhead(1e-3 * float(taus[:, 0].sum()))
        secs = float(sum(t1 * t_step + t2 * t_gossip for t1, t2 in taus))
        ctrl.observe_chunk(taus, secs * (1 + 0.02 * rng.standard_normal()))
        for i in range(len(taus)):
            ctrl.observe_participation(*masks.masks(r + i))
        r += len(taus)
    fitted = ctrl.fitted_cost_model()
    out += [ctrl.history, ctrl.spent_s, ctrl.spent_bits, ctrl.spent_j,
            ctrl.fit_rank(), ctrl.availability(), fitted.compute,
            fitted.link, ctrl.exhausted, r]
    return out


@pytest.mark.parametrize("comp,process", [("none", None), ("qsgd", None),
                                          ("top_k", "fade")])
def test_controller_equals_reference_over_recorded_observations(comp,
                                                                process):
    """Both controllers, fed one recorded observation sequence (observe,
    observe_chunk, observe_participation, spend_overhead, maybe_replan,
    predict_trajectory, next_trajectory), emit the same plans,
    trajectories, history and fitted model, bit for bit."""
    c, jc = comps(comp)
    got = _recorded_session(adaptive, cost, ring(10), c, process)
    want = _recorded_session(jadaptive, jcost, jtopology.ring(10), jc,
                             process)
    assert got[-1] > 20                       # rounds actually planned
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert same(a, b), i


# -- the loop that drives the executor from the controller ------------------


def test_planned_run_closes_the_loop_on_the_cpu(monkeypatch):
    """``cnn_planned_run`` on the MNIST CNN (4 nodes, batch 2, maxima of
    DEFAULT_GRID) on a simulated clock that each dispatch advances by
    50 ms a local step and 5 ms a gossip step (the loop's own host time
    costs nothing, so the plans do not depend on the machine's load): the
    neutral prior's round, the probe on the second chunk's last row, once,
    then plans off the exact fit; nothing built or captured after the
    warmup, every loss finite, the spend within the budget plus one chunk,
    and the realized schedule the one the controller emitted."""
    import types

    from repro_torch.launch import planned_run

    clock = [0.0]
    monkeypatch.setattr(planned_run, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))
    seen = []

    def dispatch(ex, state, batches, taus):
        rows = np.asarray(taus)
        seen.append((rows.copy(), tuple(b.shape[:2] for b in batches)))
        assert ex.tau1_max == 16 and ex.tau2_max == 8
        clock[0] += 0.05 * rows[:, 0].sum() + 0.005 * rows[:, 1].sum()
        return ex.dispatch_trajectory(state, batches, taus)

    _, rec = planned_run.cnn_planned_run("mnist", nodes=4, batch=2,
                                         budget_s=2.5, superstep=3,
                                         device="cpu", dispatch=dispatch)
    chunks = rec["chunks"]
    assert len(chunks) >= 3
    assert rec["rounds"] == sum(len(c["taus"]) for c in chunks)
    assert rec["builds_after_warmup"] == 0
    assert rec["captures_after_warmup"] == 0
    assert all(math.isfinite(v) for c in chunks
               for v in c["loss"] + c["consensus_sq"])
    largest = max(c["seconds"] + c["overhead_s"] for c in chunks)
    assert 2.5 - largest <= rec["spent_s"] <= 2.5 + largest
    trajectories = [p for p in rec["plans"] if p["cause"] == "trajectory"]
    assert [p["schedule"] for p in trajectories] == [c["taus"]
                                                     for c in chunks]
    assert trajectories[0]["schedule"] == [[1, 1]]     # the prior's round
    probes = [p["probe"] for p in trajectories if p["probe"] is not None]
    assert len(probes) == 1 and trajectories[1]["probe"] is not None
    assert rec["fitted"]["t_compute_step"] == pytest.approx(0.05, rel=1e-9)
    assert rec["fitted"]["t_gossip_step"] == pytest.approx(0.005, rel=1e-9)
    # each chunk's batches are [k, largest tau1, ...]
    for (taus, shapes), c in zip(seen, chunks):
        assert taus.tolist() == c["taus"]
        assert all(s == (len(taus), int(taus[:, 0].max())) for s in shapes)


def test_narrow_batches_match_padded_batches():
    """The dense executor reads round i's first tau1 steps only, so batch
    leaves [K, T, ...] with T the superstep's largest tau1 give the
    dispatch of the same rounds padded to [K, tau1_max, ...], bitwise."""
    from repro_torch.core import DFLConfig, RoundExecutor, init_state
    from repro_torch.optim import sgd

    rng = np.random.default_rng(3)
    data = rng.normal(size=(3, 8, 6, 5)).astype(np.float32)
    taus = np.array([[2, 1], [3, 0], [1, 2]], np.int32)

    def loss(p, b):
        return 0.5 * torch.sum((p["w"] - b) ** 2)

    outs = []
    for width in (3, 8):
        ex = RoundExecutor(DFLConfig(tau1=8, tau2=2, topology=ring(6)), loss,
                           sgd(0.1))
        st = init_state({"w": torch.zeros(5)}, 6, sgd(0.1))
        st, m = ex.dispatch_trajectory(st, torch.from_numpy(
            data[:, :width].copy()), taus)
        outs.append((st.params["w"], m["loss"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# -- the examples that read the planner -------------------------------------


def test_plan_schedule_smoke_equals_reference(tmp_path, capsys):
    """``examples/plan_schedule.py --smoke`` on the port writes the
    reference's report, bit for bit (the reference's measured column comes
    from its own numpy ``run_dfl_quadratic``)."""
    import json
    import subprocess
    import sys

    from repro_torch.examples import plan_schedule

    report = plan_schedule.main(["--smoke", "--json",
                                 str(tmp_path / "port.json")])
    assert report["regimes"] and "planned" in capsys.readouterr().out
    root = os.path.join(os.path.dirname(__file__), "..")
    subprocess.run([sys.executable, os.path.join(root, "examples",
                                                 "plan_schedule.py"),
                    "--smoke", "--json", str(tmp_path / "ref.json")],
                   check=True, capture_output=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=os.path.join(root,
                                                                "src")))
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "ref.json").read_text()))


def test_compression_sweep_runs_on_cpu(capsys):
    from repro_torch.examples import compression_sweep

    rows = compression_sweep.main(["--rounds", "1", "--device", "cpu"])
    assert [r["variant"] for r in rows] == [v[0] for v in
                                            compression_sweep.VARIANTS]
    assert all(math.isfinite(r["loss"]) and r["gb_sent"] > 0 for r in rows)
    assert "loss/GB frontier" in capsys.readouterr().out
