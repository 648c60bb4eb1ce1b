"""C-DFL compression sweep: accuracy-vs-bytes frontier (paper Fig. 10).

For each compression operator, trains the paper's CNN with C-DFL on the
10-node ring and prints the loss reached per GB of gossip traffic — the
communication-efficiency frontier the paper's wall-clock plot captures.
The port of ``examples/compression_sweep.py``, through the port's
``run_dfl_cnn`` (on the card: K1 for plain DFL, K4 + K3 for TopK, K2 for
QSGD, K7 (+ K4) for RandK and randomized gossip)::

    PYTHONPATH=src python -m repro_torch.examples.compression_sweep \\
        [--rounds 15] [--device cuda]
"""
from __future__ import annotations

import argparse
from typing import Dict, List

from repro_torch.benchmarks.common import RunSpec, run_dfl_cnn

VARIANTS = [
    ("uncompressed DFL", "", {}),
    ("top_k frac=0.5", "top_k", {"frac": 0.5}),
    ("rand_k frac=0.5", "rand_k", {"frac": 0.5}),
    ("qsgd s=16", "qsgd", {"levels": 16}),
    ("rand_gossip p=0.7", "rand_gossip", {"p": 0.7}),
]


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(f"{'variant':22s} {'loss':>8s} {'acc':>7s} {'GB sent':>8s} "
          f"{'loss/GB frontier':>16s}")
    rows = []
    for label, comp, kw in VARIANTS:
        spec = RunSpec(name=f"sweep-{comp or 'none'}", tau1=4, tau2=4,
                       topology="ring", compression=comp, comp_kwargs=kw,
                       gamma=1.0 if not comp else 0.6, rounds=a.rounds)
        out = run_dfl_cnn(spec, device=a.device, log_every=5)
        h = out["history"]
        gb = h["gbits"][-1] / 8
        rows.append({"variant": label, "loss": h["loss"][-1],
                     "test_acc": h["test_acc"][-1], "gb_sent": gb})
        print(f"{label:22s} {h['loss'][-1]:8.4f} {h['test_acc'][-1]:7.3f} "
              f"{gb:8.2f} {h['loss'][-1]/max(gb,1e-9):16.4f}")
    return rows


if __name__ == "__main__":
    main()
