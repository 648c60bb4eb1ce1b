"""The port's paper-figure benchmarks, one per table or figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run              # reduced
    PYTHONPATH=src python -m repro_torch.benchmarks.run --full       # longer
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig7 \
        --device cpu

Emits CSV rows (bench,label,...) per bench and writes each bench's JSON
under ``results/repro_torch/``. The reference's ``theory`` and ``balance``
benches read the planner, which the port does not have yet (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks import (fig7_tau2, fig8_tau1, fig9_zeta,
                                    fig10_cdfl, table1_methods)

BENCHES = ("fig7", "fig8", "fig9", "fig10", "table1")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="longer runs (closer to paper scale)")
    ap.add_argument("--only", default="",
                    help="comma list of " + ",".join(BENCHES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rounds = 150 if args.full else 40
    only = set(args.only.split(",")) if args.only else set(BENCHES)
    unknown = only - set(BENCHES)
    if unknown:
        ap.error(f"unknown benches {sorted(unknown)}")
    dev = args.device
    t0 = time.time()
    if "fig7" in only:
        print("# Fig 7 — effect of tau2 (DFL vs C-SGD), ring")
        fig7_tau2.run(rounds=rounds, device=dev)
        if args.full:
            print("# Fig 7 — quasi-ring")
            fig7_tau2.run(rounds=rounds, topology="quasi", device=dev)
            print("# Fig 7 — cifar-shaped")
            fig7_tau2.run(rounds=rounds, flavor="cifar", device=dev)
    if "fig8" in only:
        print("# Fig 8 — effect of tau1")
        fig8_tau1.run(rounds=rounds, device=dev)
    if "fig9" in only:
        print("# Fig 9 — effect of zeta")
        fig9_zeta.run(rounds=rounds, device=dev)
    if "fig10" in only:
        print("# Fig 10 — C-DFL compression")
        fig10_cdfl.run(rounds=rounds, device=dev)
    if "table1" in only:
        print("# Table I — method comparison")
        table1_methods.run(budget_iters=1200 if args.full else 480,
                           device=dev)
    print(f"\n# total bench wall-clock: {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
