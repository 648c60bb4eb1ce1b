"""Fig. 9: effect of the topology parameter zeta on convergence.

Paper claim: with tau1 = 2, tau2 = 4, smaller zeta converges better;
zeta = 0 (C = J) is the best benchmark (Remark 2 / Corollary 2). The port
of ``benchmarks/fig9_zeta.py``.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (RunSpec, print_csv, run_dfl_cnn,
                                           save_result)

TOPOLOGIES = (("full", 0.0), ("quasi", 0.85), ("ring", 0.8727))


def run(rounds: int = 60, flavor: str = "mnist", device="cuda",
        results_dir=None):
    rows = []
    results = {}
    for topo, zeta in TOPOLOGIES:
        # pathological non-IID + a single gossip step per round makes the
        # topology (zeta) the binding constraint, as in the paper's Fig. 9.
        spec = RunSpec(name=f"fig9-{topo}", tau1=2, tau2=1, topology=topo,
                       flavor=flavor, rounds=rounds * 2,
                       partition="label_shard")
        out = run_dfl_cnn(spec, device=device)
        results[spec.name] = out
        h = out["history"]
        rows.append({"bench": "fig9", "topology": topo,
                     "zeta": round(out["zeta"], 4),
                     "final_loss": round(h["global_loss"][-1], 4),
                     "final_acc": round(h["test_acc"][-1], 4),
                     "consensus": f'{h["consensus"][-1]:.2e}'})
    save_result(f"fig9_{flavor}", results, results_dir)
    print_csv(rows, ["bench", "topology", "zeta", "final_loss", "final_acc",
                     "consensus"])
    return rows


if __name__ == "__main__":
    run()
