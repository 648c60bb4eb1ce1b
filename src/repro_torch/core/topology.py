"""Gossip topologies and their confusion (mixing) matrices.

A copy of ``repro.core.topology``, which is numpy-only: the port imports nothing
of the JAX package, so the same seed gives the same bytes here.

The paper (Sec. II, Assumption 1.6) requires a doubly-stochastic, symmetric
confusion matrix C whose second-largest-magnitude eigenvalue
``zeta = max{|lambda_2|, |lambda_N|} < 1``. This module constructs the
standard graph families used in the paper (ring, quasi-ring, fully connected)
plus the families natural to a TPU mesh (torus, hypercube) and exposes the
spectral quantities the theory needs (zeta, beta = ||I - C||_2, spectral gap
rho = 1 - zeta).

All matrices are small (N x N with N = #DFL nodes, typically 10..32) and are
built in NumPy at trace time; they enter jitted code as constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "Topology",
    "ring",
    "quasi_ring",
    "fully_connected",
    "disconnected",
    "torus",
    "hypercube",
    "star",
    "from_adjacency",
    "paper_quasi_ring",
    "zeta",
    "beta",
    "spectral_gap",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A gossip topology: confusion matrix + sparse neighbor structure.

    Attributes:
      name: human-readable family name.
      mixing: (N, N) float64 doubly-stochastic symmetric confusion matrix C.
        ``mixing[j, i]`` is the contribution of node j to the average at
        node i (paper's c_ji).
      neighbors: for each node i, the list of (j, weight) pairs with
        nonzero C[j, i], EXCLUDING the self entry. Used by the sparse
        ppermute mixing path.
      self_weights: (N,) diagonal of C.
    """

    name: str
    mixing: np.ndarray
    neighbors: Tuple[Tuple[Tuple[int, float], ...], ...]
    self_weights: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.mixing.shape[0]

    @property
    def zeta(self) -> float:
        return zeta(self.mixing)

    @property
    def beta(self) -> float:
        return beta(self.mixing)

    @property
    def spectral_gap(self) -> float:
        return spectral_gap(self.mixing)

    @property
    def max_degree(self) -> int:
        return max((len(n) for n in self.neighbors), default=0)

    def is_shift_structured(self) -> bool:
        """True if every node's neighbor set is {i+s mod N} for a common set
        of shifts with shift-invariant weights (circulant C). Such topologies
        lower to one ``ppermute`` per shift on a TPU ring, and are exactly
        the ones the sparse engine (``core.sharded``) accepts — this
        predicate is THE engine-eligibility test, so it must agree with
        ``shifts()``: non-empty shifts, or the explicit degenerate no-edge
        case C = I (zero shifts — a doubly stochastic matrix with no
        off-diagonal mass is the identity), where the sparse engine's gossip
        is a no-op rather than an error."""
        if self.num_nodes == 0:
            return False
        if self.max_degree == 0:
            return bool(np.allclose(self.mixing,
                                    np.eye(self.num_nodes), atol=1e-12))
        return len(self.shifts()) > 0

    def edges(self) -> Tuple[Tuple[int, int], ...]:
        """Canonical undirected edge list: sorted (i, j) pairs with i < j.

        This ordering is THE edge enumeration contract for participation
        masks: ``edge_mask[e]`` in ``round_body`` / ``FaultPlan`` refers to
        ``edges()[e]``, and both directions of an undirected edge share the
        one mask entry (masking is symmetric, so the confusion matrix stays
        symmetric doubly stochastic after renormalization).
        """
        out = set()
        for i, nbrs in enumerate(self.neighbors):
            for (j, _) in nbrs:
                out.add((min(i, j), max(i, j)))
        return tuple(sorted(out))

    @property
    def num_edges(self) -> int:
        return len(self.edges())

    def edge_index(self) -> Dict[Tuple[int, int], int]:
        """Map (i, j) with i < j -> position in ``edges()``."""
        return {e: k for k, e in enumerate(self.edges())}

    def shifts(self) -> List[Tuple[int, float]]:
        """Common (shift, weight) structure if C is circulant, else []."""
        n = self.num_nodes
        if n == 0:
            return []
        base: Dict[int, float] = {}
        for (j, w) in self.neighbors[0]:
            base[(j - 0) % n] = w
        for i in range(1, n):
            cur: Dict[int, float] = {}
            for (j, w) in self.neighbors[i]:
                cur[(j - i) % n] = w
            if set(cur) != set(base):
                return []
            for s, w in cur.items():
                if abs(w - base[s]) > 1e-12:
                    return []
        return sorted(base.items())

    def validate(self) -> None:
        c = self.mixing
        n = c.shape[0]
        assert c.shape == (n, n), "C must be square"
        assert np.allclose(c, c.T, atol=1e-12), "C must be symmetric"
        assert np.allclose(c.sum(axis=0), 1.0, atol=1e-10), "C must be stochastic"
        assert (c >= -1e-12).all(), "C must be nonnegative"


def _neighbors_from_matrix(c: np.ndarray) -> Tuple[Tuple[Tuple[int, float], ...], ...]:
    n = c.shape[0]
    out: List[Tuple[Tuple[int, float], ...]] = []
    for i in range(n):
        row = tuple(
            (j, float(c[j, i])) for j in range(n) if j != i and c[j, i] > 1e-15
        )
        out.append(row)
    return tuple(out)


def _make(name: str, c: np.ndarray) -> Topology:
    c = np.asarray(c, dtype=np.float64)
    topo = Topology(
        name=name,
        mixing=c,
        neighbors=_neighbors_from_matrix(c),
        self_weights=np.diag(c).copy(),
    )
    topo.validate()
    return topo


def from_adjacency(name: str, adj: np.ndarray, scheme: str = "uniform") -> Topology:
    """Build a doubly stochastic C from a 0/1 symmetric adjacency matrix.

    scheme:
      "uniform"    — node i averages itself and its neighbors with equal
                     weight 1/(deg_max+1) and keeps the remainder on the
                     diagonal (lazy Metropolis with global max degree; always
                     doubly stochastic for symmetric adj).
      "metropolis" — Metropolis-Hastings weights 1/(1+max(deg_i, deg_j)).
    """
    adj = np.asarray(adj)
    n = adj.shape[0]
    assert (adj == adj.T).all(), "adjacency must be symmetric"
    assert (np.diag(adj) == 0).all(), "no self loops in adjacency"
    deg = adj.sum(axis=1)
    c = np.zeros((n, n), dtype=np.float64)
    if scheme == "uniform":
        dmax = max(int(deg.max()), 1)
        w = 1.0 / (dmax + 1)
        c = adj * w
        np.fill_diagonal(c, 1.0 - c.sum(axis=1))
    elif scheme == "metropolis":
        for i in range(n):
            for j in range(n):
                if adj[i, j]:
                    c[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        np.fill_diagonal(c, 1.0 - c.sum(axis=1))
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return _make(name, c)


def ring(n: int) -> Topology:
    """Ring of n nodes; each node averages itself + 2 neighbors with 1/3.

    This is the paper's main experimental topology (Fig. 6 left; with n=10,
    zeta = (1 + 2 cos(2 pi/10)) / 3 ~= 0.873, matching the paper's 0.87).
    """
    assert n >= 2
    adj = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1
    return from_adjacency(f"ring-{n}", adj)


def quasi_ring(n: int, chords: Sequence[Tuple[int, int]] = ()) -> Topology:
    """Ring plus chord edges (paper Fig. 6 right adds shortcuts to the ring;
    with one chord on a 10-ring zeta drops to ~0.85 as the paper reports).

    Default chord set for even n: one diameter chord (0, n//2).
    """
    assert n >= 4
    adj = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1
    use = list(chords) if chords else [(0, n // 2)]
    for (a, b) in use:
        adj[a % n, b % n] = adj[b % n, a % n] = 1
    return from_adjacency(f"quasi-ring-{n}", adj)


def paper_quasi_ring() -> Topology:
    """The 10-node quasi-ring calibrated to the paper's reported zeta = 0.85.

    The paper (Sec. VI-A / Fig. 6 right) states zeta = 0.85 for its
    quasi-ring but does not give the exact weights. We take the 10-ring with
    1/3 edge weights plus two diameter-ish chords (0,5), (2,7) whose weight
    w* ~= 0.0447 is bisected so that zeta = 0.8500 exactly (see
    tests/test_topology.py).
    """
    n = 10
    w = 0.04469696969697019
    c = np.zeros((n, n))
    for i in range(n):
        c[i, (i + 1) % n] = c[(i + 1) % n, i] = 1.0 / 3.0
    for (a, b) in ((0, 5), (2, 7)):
        c[a, b] = c[b, a] = w
    for i in range(n):
        c[i, i] = 1.0 - c[i].sum()
    return _make("paper-quasi-ring-10", c)


def fully_connected(n: int) -> Topology:
    """C = J: perfect averaging in one step (zeta = 0). Paper's synchronous
    SGD benchmark (Corollary 2)."""
    c = np.full((n, n), 1.0 / n)
    return _make(f"full-{n}", c)


def disconnected(n: int) -> Topology:
    """C = I: no communication at all (zeta = 1, worst case of Remark 2)."""
    return _make(f"disconnected-{n}", np.eye(n))


def torus(rows: int, cols: int) -> Topology:
    """2-D torus matching a TPU ICI mesh slice; 4 neighbors per node."""
    n = rows * cols
    adj = np.zeros((n, n), dtype=np.int64)

    def idx(r: int, c: int) -> int:
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            for (dr, dc) in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = idx(r + dr, c + dc)
                if i != j:
                    adj[i, j] = adj[j, i] = 1
    return from_adjacency(f"torus-{rows}x{cols}", adj)


def hypercube(dim: int) -> Topology:
    """2^dim nodes; neighbors differ in one bit. log-diameter gossip."""
    n = 1 << dim
    adj = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for b in range(dim):
            j = i ^ (1 << b)
            adj[i, j] = adj[j, i] = 1
    return from_adjacency(f"hypercube-{dim}", adj)


def star(n: int) -> Topology:
    """Hub-and-spoke (centralized FL's implicit topology, for comparison)."""
    assert n >= 2
    adj = np.zeros((n, n), dtype=np.int64)
    for i in range(1, n):
        adj[0, i] = adj[i, 0] = 1
    return from_adjacency(f"star-{n}", adj)


def zeta(c: np.ndarray) -> float:
    """max{|lambda_2|, |lambda_N|}: the paper's mixing parameter."""
    ev = np.sort(np.abs(np.linalg.eigvalsh(np.asarray(c, dtype=np.float64))))
    if len(ev) < 2:
        return 0.0
    return float(ev[-2])


def beta(c: np.ndarray) -> float:
    """||I - C||_2 in [0, 2] (Assumption 1.6)."""
    c = np.asarray(c, dtype=np.float64)
    return float(np.linalg.norm(np.eye(c.shape[0]) - c, ord=2))


def spectral_gap(c: np.ndarray) -> float:
    """rho = 1 - zeta in (0, 1] (used by C-DFL's Prop. 2)."""
    return 1.0 - zeta(c)
