"""Fig. 8: effect of tau1 (computation frequency).

Paper claim (Remark 1): more local updates per round intensify local
drift. Protocol: EQUAL SGD-STEP budget (rounds = budget / tau1) so every
variant performs the same number of gradient steps and differs ONLY in how
much drift accumulates between averagings; synchronous SGD (tau1 = 1,
C = J) is the drift-free benchmark (Corollary 1). The port of
``benchmarks/fig8_tau1.py``.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (RunSpec, print_csv, run_dfl_cnn,
                                           save_result)

TAU1S = (2, 4, 10)


def run(rounds: int = 60, flavor: str = "mnist", device="cuda",
        results_dir=None):
    rows = []
    results = {}
    sgd_budget = rounds * 2  # total local update steps for every variant
    # benchmark: synchronous SGD (tau1=1, C=J)  [Corollary 1]
    sync = RunSpec(name="fig8-sync", tau1=1, tau2=1, topology="full",
                   flavor=flavor, rounds=sgd_budget,
                   partition="label_shard")
    out = run_dfl_cnn(sync, device=device)
    results[sync.name] = out
    rows.append({"bench": "fig8", "label": "sync-SGD", "tau1": 1,
                 "loss_at_iter_budget": round(
                     out["history"]["global_loss"][-1], 4),
                 "final_acc": round(out["history"]["test_acc"][-1], 4)})
    for tau1 in TAU1S:
        r = max(4, sgd_budget // tau1)
        spec = RunSpec(name=f"fig8-tau1{tau1}", tau1=tau1, tau2=4,
                       topology="ring", flavor=flavor, rounds=r,
                       partition="label_shard")
        out = run_dfl_cnn(spec, device=device)
        results[spec.name] = out
        h = out["history"]
        rows.append({"bench": "fig8", "label": f"DFL tau1={tau1}",
                     "tau1": tau1,
                     "loss_at_iter_budget": round(h["global_loss"][-1], 4),
                     "final_acc": round(h["test_acc"][-1], 4)})
    save_result(f"fig8_{flavor}", results, results_dir)
    print_csv(rows, ["bench", "label", "tau1", "loss_at_iter_budget",
                     "final_acc"])
    return rows


if __name__ == "__main__":
    run()
