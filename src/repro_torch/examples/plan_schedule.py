"""Plan -> train -> report: the resource-constrained planner end-to-end.

Eight nodes on a ring, a wall-clock budget, and a grid of (tau1, tau2)
schedules: the planner picks the schedule minimizing the Proposition-1
objective under the budget, Algorithm 1 runs it (analytic quadratic
testbed, so every constant is exact), and the report compares the
planner's predicted cost/quality against what the run actually measured —
for the planned schedule AND every rejected grid point.

The port of ``examples/plan_schedule.py``: numpy only, through the port's
planner and ``repro_torch.benchmarks.theory_check.run_dfl_quadratic``, so
its report is the reference's.

    PYTHONPATH=src python -m repro_torch.examples.plan_schedule
    PYTHONPATH=src python -m repro_torch.examples.plan_schedule --smoke \
        --json out.json
"""
import argparse
import json

import numpy as np

from repro_torch.benchmarks.theory_check import run_dfl_quadratic
from repro_torch.core.topology import ring
from repro_torch.planner import (Budget, evaluate_grid, select_plan,
                                 unit_cost_model)

N = 8
DIM = 16
SIGMA = 0.5        # sampling noise
TSCALE = 0.8       # heterogeneity (non-IID target spread)
GRID = [(1, 4), (1, 2), (2, 2), (2, 1), (4, 1), (8, 1)]
RATIOS = (0.2, 25.0)       # t_gossip / t_compute regimes to plan for
REF_ROUNDS = 60            # budget = 60 rounds of the (2, 2) schedule


def testbed_constants(topo):
    rng = np.random.default_rng(0)
    targets = rng.normal(size=(topo.num_nodes, DIM)) * TSCALE
    tbar = targets.mean(0)
    f_gap = 0.5 * float(np.sum(tbar**2))
    sigma_eff = np.sqrt(
        SIGMA**2 + float(np.max(np.sum((targets - tbar) ** 2, axis=1))))
    return f_gap, sigma_eff


def measured(eta, tau1, tau2, topo, rounds, seeds):
    return float(np.mean([
        run_dfl_quadratic(eta, tau1, tau2, topo, rounds, d=DIM, sigma=SIGMA,
                          seed=s, target_scale=TSCALE)[0]
        for s in range(seeds)]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="4-point sweep with 1 seed")
    ap.add_argument("--json", default="", help="write the report here")
    args = ap.parse_args(argv)
    seeds = 1 if args.smoke else 4
    grid = GRID[:3] + GRID[-1:] if args.smoke else GRID

    topo = ring(N)
    f_gap, sigma_eff = testbed_constants(topo)
    report = {"nodes": N, "zeta": topo.zeta, "grid": grid, "regimes": []}
    print(f"{N}-node ring (zeta={topo.zeta:.3f}), budget = {REF_ROUNDS} "
          f"reference rounds, sigma_eff={sigma_eff:.2f}\n")
    for ratio in RATIOS:
        cost_model = unit_cost_model(topo, ratio)
        budget = Budget(
            wall_clock_s=cost_model.round_cost(2, 2).time_s * REF_ROUNDS)
        cands = evaluate_grid(budget, cost_model, sigma=sigma_eff,
                              f_gap=f_gap, grid=grid)
        p = select_plan(cands)
        rows = []
        for cand in cands:
            m = measured(cand.eta, cand.tau1, cand.tau2, topo, cand.rounds,
                         seeds)
            rows.append({
                "tau1": cand.tau1, "tau2": cand.tau2,
                "rounds_in_budget": cand.rounds,
                "eta": round(cand.eta, 5),
                "predicted": round(cand.predicted_bound, 5),
                "measured": round(m, 5),
                "planned": (cand.tau1, cand.tau2) == (p.tau1, p.tau2),
            })
        rows.sort(key=lambda r: r["measured"])
        report["regimes"].append({
            "comm_compute_ratio": ratio,
            "budget_s": budget.wall_clock_s,
            "planned": {"tau1": p.tau1, "tau2": p.tau2,
                        "predicted_bound": p.predicted_bound},
            "table": rows,
        })
        print(f"comm/compute ratio {ratio}: planned tau=({p.tau1},{p.tau2})")
        print(f"  {'tau':>8s} {'rounds':>7s} {'eta':>8s} "
              f"{'predicted':>10s} {'measured':>9s}")
        for r in rows:
            mark = " <- planned" if r["planned"] else ""
            print(f"  ({r['tau1']},{r['tau2']}){'':>3s} "
                  f"{r['rounds_in_budget']:>7d} {r['eta']:>8.4f} "
                  f"{r['predicted']:>10.4f} {r['measured']:>9.5f}{mark}")
        best = rows[0]
        print(f"  measured best: ({best['tau1']},{best['tau2']}) — planner "
              f"{'agrees' if best['planned'] else 'close (bound-argmin)'}\n")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report -> {args.json}")
    return report


if __name__ == "__main__":
    main()
