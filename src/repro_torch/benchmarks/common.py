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
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.launch.cnn_run import RunSpec, run_dfl_cnn

__all__ = ["RESULTS_DIR", "RunSpec", "run_dfl_cnn", "save_result",
           "print_csv", "kernel_events", "busy_ms"]

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


Kernel = Tuple[object, float, float, str]   # (stream, start us, end us, name)


def kernel_events(prof) -> List[Kernel]:
    """The device kernels of a finished ``torch.profiler.profile``: its
    kineto results' device events but the copies and fills (named
    ``Memcpy ...`` / ``Memset ...``, as in its chrome trace, where the
    rest are category ``kernel``). Read directly: a flight of decode steps
    holds some 275,000 kernels, and its chrome trace (0.28 GB) took longer
    to write and parse than the flight to run."""
    from torch.autograd import DeviceType

    return [(e.device_resource_id(), e.start_ns() / 1e3, e.end_ns() / 1e3,
             e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.name().startswith(("Memcpy", "Memset"))]


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """Overlapping ``(start, end)`` intervals merged, in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ms(kernels: Sequence[Kernel]) -> float:
    """Time in ms during which at least one kernel ran: the union of the
    kernels' intervals. Summed kernel times count more, since a kernel on
    Hopper may start before the one it depends on has ended."""
    return sum(b - a for a, b in union([(a, b) for _, a, b, _ in kernels])
               ) / 1e3
