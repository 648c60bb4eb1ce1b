"""The paper's headline trade-off: balancing communication and computing
costs under a WALL-CLOCK budget (abstract / Sec. I). The port of
``benchmarks/bench_balance.py``.

For a grid of (tau1, tau2) we measure convergence per ROUND empirically and
price round wall-clock with the planner's cost model (one local step = 1
compute unit, one gossip step = the comm/comp ratio being swept); the best
(tau1, tau2) shifts toward more local computation as links get slower — the
balance DFL exposes and C-SGD/D-SGD cannot tune.

The planner (``repro_torch.planner``) picks its schedule from Proposition 1
*before* seeing any measurement; this benchmark is its empirical
validation: the JSON records both the measured winner per ratio and the
planner's a-priori pick. The grid runs through ``run_dfl_cnn`` (plain DFL:
K1 once per gossip step on the card).

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only balance

Writes ``results/repro_torch/balance_<flavor>.json``.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (RunSpec, print_csv, run_dfl_cnn,
                                           save_result)
from repro_torch.core.topology import ring
from repro_torch.planner import Budget, plan, rounds_within, unit_cost_model

GRID = [(1, 1), (2, 2), (4, 1), (4, 4), (8, 2), (1, 4)]
# compute:comm cost ratios to evaluate (t_comm / t_compute per step).
RATIOS = (0.2, 1.0, 5.0)
# Wall-clock budget = this many rounds of the reference (4, 4) schedule.
BUDGET_REF_ROUNDS = 40
NODES = 10


def budget_for(ratio: float) -> Budget:
    cm = unit_cost_model(ring(NODES), ratio)
    return Budget(wall_clock_s=cm.round_cost(4, 4).time_s * BUDGET_REF_ROUNDS)


def run(flavor: str = "mnist", rounds: int = 50, device="cuda",
        results_dir=None):
    runs = {}
    for (t1, t2) in GRID:
        spec = RunSpec(name=f"bal-{t1}-{t2}", tau1=t1, tau2=t2,
                       topology="ring", flavor=flavor, rounds=rounds)
        runs[(t1, t2)] = run_dfl_cnn(spec, device=device)
    rows = []
    results = {"runs": {f"{k}": v for k, v in runs.items()}, "winners": {},
               "planned": {}}
    for ratio in RATIOS:
        cost_model = unit_cost_model(ring(NODES), ratio)
        budget = budget_for(ratio)
        best = None
        for (t1, t2), out in runs.items():
            h = out["history"]
            n_rounds = rounds_within(budget, cost_model.round_cost(t1, t2))
            idx = min(range(len(h["round"])),
                      key=lambda i: abs(h["round"][i] - n_rounds))
            loss = h["global_loss"][idx]
            rows.append({"bench": "balance", "comm/comp": ratio,
                         "tau1": t1, "tau2": t2,
                         "rounds_in_budget": n_rounds,
                         "loss_at_budget": round(loss, 4)})
            if best is None or loss < best[0]:
                best = (loss, t1, t2)
        results["winners"][str(ratio)] = best
        # the planner's a-priori pick over the SAME grid and budget (CNN
        # constants are unknown; generic sigma/f_gap rank the grid).
        p = plan(budget, cost_model, sigma=1.0, f_gap=1.0, grid=GRID)
        results["planned"][str(ratio)] = {
            "tau1": p.tau1, "tau2": p.tau2, "eta": p.eta,
            "rounds": p.rounds, "predicted_bound": p.predicted_bound,
        }
        rows.append({"bench": "balance", "comm/comp": ratio,
                     "tau1": f"BEST={best[1]}", "tau2": best[2],
                     "rounds_in_budget": "",
                     "loss_at_budget": round(best[0], 4)})
    save_result(f"balance_{flavor}", results, results_dir)
    print_csv(rows, ["bench", "comm/comp", "tau1", "tau2",
                     "rounds_in_budget", "loss_at_budget"])
    return rows


if __name__ == "__main__":
    run()
