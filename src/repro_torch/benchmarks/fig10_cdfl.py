"""Fig. 10: C-DFL communication efficiency under compression.

Paper claims (tau1 = tau2 = 4, gamma = 1, 10-node ring):
 (a) against COMMUNICATION VOLUME (exact wire bits, the paper's wall-clock
     on a real NIC being out of reach): moderate compression (top_k
     delta~0.89/0.67, rand-gossip p=0.8) converges FASTER than uncompressed
     DFL per byte;
 (b) against ITERATIONS: compression is slightly worse, and worse for
     smaller delta.
The port of ``benchmarks/fig10_cdfl.py``.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (RunSpec, print_csv, run_dfl_cnn,
                                           save_result)

VARIANTS = [
    ("DFL", "", {}),
    ("top_k d=0.89", "top_k", {"frac": 0.89}),
    ("top_k d=0.67", "top_k", {"frac": 0.67}),
    ("rand_gossip p=0.8", "rand_gossip", {"p": 0.8}),
    ("rand_gossip p=0.6", "rand_gossip", {"p": 0.6}),
]


def loss_at_gbits(history, budget_gbits):
    """First logged loss once cumulative traffic exceeds the budget."""
    for gb, loss in zip(history["gbits"], history["global_loss"]):
        if gb >= budget_gbits:
            return loss
    return history["global_loss"][-1]


def run(rounds: int = 60, flavor: str = "mnist", device="cuda",
        results_dir=None):
    rows = []
    runs = {}
    for label, comp, kw in VARIANTS:
        spec = RunSpec(name=f"fig10-{comp or 'dfl'}-{kw}",
                       tau1=4, tau2=4, topology="ring", compression=comp,
                       comp_kwargs=kw, gamma=1.0 if not comp else 0.6,
                       flavor=flavor, rounds=rounds)
        runs[label] = run_dfl_cnn(spec, device=device)
    # common byte budget = half of what uncompressed DFL used.
    budget = runs["DFL"]["history"]["gbits"][-1] * 0.5
    for label, out in runs.items():
        h = out["history"]
        rows.append({
            "bench": "fig10", "label": label,
            "bits_per_round_rel": round(
                out["bits_per_round"] / runs["DFL"]["bits_per_round"], 3),
            "loss_at_byte_budget": round(loss_at_gbits(h, budget), 4),
            "final_loss_per_iter": round(h["global_loss"][-1], 4),
            "final_acc": round(h["test_acc"][-1], 4),
        })
    save_result(f"fig10_{flavor}", runs, results_dir)
    print_csv(rows, ["bench", "label", "bits_per_round_rel",
                     "loss_at_byte_budget", "final_loss_per_iter",
                     "final_acc"])
    return rows


if __name__ == "__main__":
    run()
