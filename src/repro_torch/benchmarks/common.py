"""Shared harness of the port's paper-figure benchmarks (Figs. 7-10,
Table I), the port of ``benchmarks/common.py``.

``RunSpec`` and ``run_dfl_cnn`` (``repro_torch.launch.cnn_run``) train the
paper's CNN with DFL / C-DFL on the synthetic MNIST- and CIFAR-shaped data
over the paper's 10-node topologies; results are written as JSON under
``results/repro_torch/`` at the repository root, or a directory given.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from repro_torch.launch.cnn_run import RunSpec, run_dfl_cnn

__all__ = ["RESULTS_DIR", "RunSpec", "run_dfl_cnn", "save_result",
           "print_csv"]

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "..", "..", "results", "repro_torch")


def save_result(name: str, payload: Dict,
                results_dir: Optional[str] = None) -> str:
    """Write ``payload`` as ``<results_dir>/<name>.json`` (``name`` may be
    an absolute path); returns the path."""
    path = os.path.join(results_dir or RESULTS_DIR, name + ".json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def print_csv(rows: List[Dict], cols: List[str]) -> None:
    print(",".join(cols))
    for row in rows:
        print(",".join(str(row.get(c, "")) for c in cols))
