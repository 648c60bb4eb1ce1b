"""Fig. 7: accelerated convergence of DFL vs C-SGD as tau2 grows.

Paper claim: with tau1 = 4 fixed, training loss and test accuracy improve
monotonically with tau2 (tau2 = 1 is C-SGD, the worst; tau2 = 15 the best)
on ring and quasi-ring topologies. The port of ``benchmarks/fig7_tau2.py``.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (RunSpec, print_csv, run_dfl_cnn,
                                           save_result)

TAU2S = (1, 2, 4, 15)


def run(rounds: int = 60, flavor: str = "mnist", topology: str = "ring",
        device="cuda", results_dir=None):
    rows = []
    results = {}
    for tau2 in TAU2S:
        label = "C-SGD" if tau2 == 1 else f"DFL tau2={tau2}"
        spec = RunSpec(name=f"fig7-{flavor}-{topology}-tau2{tau2}",
                       tau1=4, tau2=tau2, topology=topology,
                       flavor=flavor, rounds=rounds)
        out = run_dfl_cnn(spec, device=device)
        results[spec.name] = out
        h = out["history"]
        rows.append({
            "bench": "fig7", "label": label, "tau2": tau2,
            "final_loss": round(h["global_loss"][-1], 4),
            "final_acc": round(h["test_acc"][-1], 4),
            "consensus": f'{h["consensus"][-1]:.2e}',
        })
    save_result(f"fig7_{flavor}_{topology}", results, results_dir)
    print_csv(rows, ["bench", "label", "tau2", "final_loss", "final_acc",
                     "consensus"])
    return rows


if __name__ == "__main__":
    run()
