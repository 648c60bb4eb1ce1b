"""Consensus/communication analytics used by the paper's illustrations.

Fig. 2/3 of the paper track, at a given node, the *coefficients* that each
initial parameter w_1..w_N contributes after t gossip steps — i.e. the
node's column of C^t — and show their variance decaying monotonically
(Proposition 1's mechanism). These are NumPy utilities, copied from
``repro.core.metrics``. Its deprecated ``comm_compute_cost`` shim, which
delegates to the planner, comes with the planner's port (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.topology import Topology

__all__ = [
    "coefficient_variance_trajectory",
    "consensus_error_trajectory",
    "rounds_to_consensus",
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
