"""Consensus/communication analytics used by the paper's illustrations.

Fig. 2/3 of the paper track, at a given node, the *coefficients* that each
initial parameter w_1..w_N contributes after t gossip steps — i.e. the
node's column of C^t — and show their variance decaying monotonically
(Proposition 1's mechanism). These are NumPy utilities, copied from
``repro.core.metrics``, with its deprecated ``comm_compute_cost`` shim,
which delegates to the port's planner (``repro_torch.planner.cost``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.topology import Topology

__all__ = [
    "coefficient_variance_trajectory",
    "consensus_error_trajectory",
    "rounds_to_consensus",
    "comm_compute_cost",
]


def coefficient_variance_trajectory(
    topology: Topology, node: int, steps: int
) -> np.ndarray:
    """Variance across nodes of column ``node`` of C^t for t = 0..steps.

    Reproduces Fig. 3: monotone decay toward 0 (consensus = uniform 1/N).
    """
    c = topology.mixing
    n = c.shape[0]
    col = np.eye(n)[:, node]
    out = []
    for _ in range(steps + 1):
        out.append(float(np.var(col)))
        col = c.T @ col
    return np.asarray(out)


def consensus_error_trajectory(topology: Topology, steps: int) -> np.ndarray:
    """||C^t - J||_2 = zeta^t for t = 0..steps (Lemma 7)."""
    n = topology.num_nodes
    j = np.full((n, n), 1.0 / n)
    c_t = np.eye(n)
    out = []
    for _ in range(steps + 1):
        out.append(float(np.linalg.norm(c_t - j, ord=2)))
        c_t = c_t @ topology.mixing
    return np.asarray(out)


def rounds_to_consensus(topology: Topology, eps: float = 1e-2) -> int:
    """Smallest t with zeta^t <= eps (analytic, from Lemma 7)."""
    z = topology.zeta
    if z <= 0:
        return 1
    if z >= 1:
        return -1  # never
    return int(np.ceil(np.log(eps) / np.log(z)))


def comm_compute_cost(
    tau1: int,
    tau2: int,
    rounds: int,
    *,
    step_flops: float,
    model_bytes: float,
    degree: int,
    flops_per_s: float,
    link_bytes_per_s: float,
    bits_per_value_ratio: float = 1.0,
) -> Dict[str, float]:
    """DEPRECATED shim: use ``repro_torch.planner.cost.comm_compute_cost``.

    The analytic time model for the paper's 'balancing' trade-off
    (total time = rounds * (tau1 * t_compute + tau2 * t_comm), t_comm =
    degree * model_bytes * bits_ratio / link_bw) lives in the planner,
    which generalizes it to topology-aware, per-engine, per-compressor
    ``CostModel`` objects. This wrapper delegates.

    Example: step_flops=1e9, model_bytes=4e6, degree=2, flops_per_s=1e12,
    link_bytes_per_s=1e9 gives t_compute=1e-3 s, t_comm=8e-3 s.
    """
    import warnings

    warnings.warn(
        "repro_torch.core.metrics.comm_compute_cost is deprecated; use "
        "repro_torch.planner.cost.comm_compute_cost (or "
        "planner.cost.CostModel)", DeprecationWarning, stacklevel=2)
    from repro_torch.planner.cost import comm_compute_cost as _planner_cost

    return _planner_cost(
        tau1, tau2, rounds, step_flops=step_flops, model_bytes=model_bytes,
        degree=degree, flops_per_s=flops_per_s,
        link_bytes_per_s=link_bytes_per_s,
        bits_per_value_ratio=bits_per_value_ratio)
