"""Table I: comparison of distributed SGD methods.

Runs FL-style sync SGD, D-SGD, C-SGD and DFL under an equal ITERATION
budget and reports loss/accuracy/consensus + per-round wire bytes, the
empirical counterpart of the paper's qualitative Table I. The port of
``benchmarks/table1_methods.py``.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (RunSpec, print_csv, run_dfl_cnn,
                                           save_result)

# (label, tau1, tau2, topology, rounds): iteration budget tau*rounds ~ 480.
METHODS = [
    ("sync-SGD (FL)", 1, 1, "full", 240),
    ("D-SGD", 1, 1, "ring", 240),
    ("C-SGD", 4, 1, "ring", 96),
    ("DFL", 4, 4, "ring", 60),
]


def run(flavor: str = "mnist", budget_iters: int = 480, device="cuda",
        results_dir=None):
    rows = []
    results = {}
    for label, t1, t2, topo, rounds in METHODS:
        rounds = max(8, min(rounds, budget_iters // (t1 + t2)))
        spec = RunSpec(name=f"table1-{label}", tau1=t1, tau2=t2,
                       topology=topo, flavor=flavor, rounds=rounds)
        out = run_dfl_cnn(spec, device=device)
        results[label] = out
        h = out["history"]
        rows.append({
            "bench": "table1", "method": label, "tau1": t1, "tau2": t2,
            "iterations": h["iteration"][-1],
            "final_loss": round(h["global_loss"][-1], 4),
            "final_acc": round(h["test_acc"][-1], 4),
            "consensus": f'{h["consensus"][-1]:.2e}',
            "gbits": round(h["gbits"][-1], 3),
        })
    save_result(f"table1_{flavor}", results, results_dir)
    print_csv(rows, ["bench", "method", "tau1", "tau2", "iterations",
                     "final_loss", "final_acc", "consensus", "gbits"])
    return rows


if __name__ == "__main__":
    run()
