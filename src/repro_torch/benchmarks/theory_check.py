"""Numerical verification of Proposition 1 (convergence bound of DFL).

On a strongly-convex quadratic where every constant in Assumption 1 is
analytic — F_i(w) = 0.5 ||w - t_i||^2, stochastic gradient g = nabla F_i +
sigma * xi with xi ~ N(0, I_d/d) — we run Algorithm 1 exactly (matrix
form, eq. (5)) and check that the measured E[ (1/T) sum_t ||nabla F(u_t)||^2 ]
is BELOW the bound (20) whenever the learning rate satisfies condition
(19). Constants: L = mu = 1; zeta/beta from the topology spectrum.

Assumption 1.5 bounds E||g(w) - nabla F(w)||^2 against the GLOBAL gradient,
so sigma^2 must include the non-IID heterogeneity max_i ||t_i - tbar||^2 on
top of the sampling noise — using only the sampling sigma understates the
bound (we verified: tau=(4,8) then appears to "violate" it by ~20%).

Also verifies the bound's structure: the measured local-drift contribution
grows with tau1 and shrinks with tau2, as Remark 1 states.

The port of ``benchmarks/theory_check.py``: numpy only, the same draws
from the same seeds, so every run equals the reference's bit for bit.

    PYTHONPATH=src python -m repro_torch.benchmarks.theory_check
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.topology import Topology, fully_connected, ring
# Condition (19) / bound (20) / max-eta live in the planner library;
# re-exported here, as the reference does.
from repro_torch.planner.bounds import bound_20, lr_condition_19, max_eta_19

__all__ = ["lr_condition_19", "bound_20", "max_eta_19",
           "run_dfl_quadratic", "quadratic_loss_gap",
           "measured_loss_at_budget", "check", "main"]


def run_dfl_quadratic(eta: float, tau1: int, tau2: int, topo: Topology,
                      rounds: int, d: int = 16, sigma: float = 0.5,
                      seed: int = 0, target_scale: float = 1.0):
    """Algorithm 1 in matrix form.

    Returns (avg ||grad F(u_t)||^2 over T, final stacked params X, the
    node targets t_i) — targets are returned so callers evaluate losses
    against the exact instance that ran instead of replaying RNG draws."""
    rng = np.random.default_rng(seed)
    n = topo.num_nodes
    targets = rng.normal(size=(n, d)) * target_scale
    tbar = targets.mean(0)
    c = topo.mixing
    x = np.zeros((n, d))                       # same init point (u_1 = 0)
    grads_sq = []

    def record():
        u = x.mean(0)
        grads_sq.append(float(np.sum((u - tbar) ** 2)))

    for _ in range(rounds):
        for _ in range(tau1):                  # local updates
            record()
            noise = rng.normal(size=(n, d)) * (sigma / np.sqrt(d))
            g = (x - targets) + noise
            x = x - eta * g
        for _ in range(tau2):                  # inter-node communication
            record()
            x = c.T @ x
    return float(np.mean(grads_sq)), x, targets


def quadratic_loss_gap(x: np.ndarray, targets: np.ndarray) -> float:
    """F(u) - F_inf of the averaged model on the quadratic testbed."""
    u = x.mean(0)
    tbar = targets.mean(0)
    return 0.5 * float(np.sum((u - tbar) ** 2))


def measured_loss_at_budget(eta: float, tau1: int, tau2: int,
                            topo: Topology, rounds: int, *, d: int = 16,
                            sigma: float = 0.5, seeds: int = 3,
                            target_scale: float = 1.0) -> float:
    """bench_balance-style empirical measurement for the planner: the mean
    (over seeds) final loss gap F(u) - F_inf after ``rounds`` rounds of the
    (tau1, tau2) schedule — the quantity a wall-clock budget buys."""
    gaps = []
    for s in range(seeds):
        _, x, targets = run_dfl_quadratic(eta, tau1, tau2, topo, rounds,
                                          d=d, sigma=sigma, seed=s,
                                          target_scale=target_scale)
        gaps.append(quadratic_loss_gap(x, targets))
    return float(np.mean(gaps))


def check(eta=None, tau1=4, tau2=2, topo=None, rounds=400, sigma=0.5,
          seeds=5, d=16):
    topo = topo or ring(8)
    n = topo.num_nodes
    if eta is None:
        eta = 0.5 * max_eta_19(tau1, tau2, topo)
    assert lr_condition_19(eta, tau1, tau2, topo), "eta violates (19)"
    measured = []
    f_gap = sigma_eff_sq = None
    for s in range(seeds):
        m, _, targets = run_dfl_quadratic(eta, tau1, tau2, topo, rounds,
                                          d=d, sigma=sigma, seed=s,
                                          target_scale=0.3)  # modest het.
        tbar = targets.mean(0)
        f_gap = 0.5 * float(np.sum(tbar**2))      # F(u_1=0) - F_inf
        # Assumption 1.5 sigma^2: sampling noise + non-IID heterogeneity.
        sigma_eff_sq = sigma**2 + float(
            np.max(np.sum((targets - tbar) ** 2, axis=1)))
        measured.append(m)
    t_total = rounds * (tau1 + tau2)
    b = bound_20(eta, tau1, tau2, topo, t_total, f_gap,
                 np.sqrt(sigma_eff_sq), n)
    return float(np.mean(measured)), b


def main():
    print("Proposition 1 numerical check (quadratic, L=mu=1):")
    print(f"{'config':34s} {'measured':>10s} {'bound(20)':>10s} {'holds':>6s}")
    rows = []
    for (tau1, tau2, topo, label) in [
        (4, 1, ring(8), "tau=(4,1) ring8   [C-SGD]"),
        (4, 2, ring(8), "tau=(4,2) ring8"),
        (4, 8, ring(8), "tau=(4,8) ring8"),
        (8, 2, ring(8), "tau=(8,2) ring8"),
        (1, 1, fully_connected(8), "tau=(1,1) C=J    [sync]"),
    ]:
        m, b = check(tau1=tau1, tau2=tau2, topo=topo)
        ok = m <= b
        rows.append(ok)
        print(f"{label:34s} {m:10.4f} {b:10.4f} {str(ok):>6s}")
    assert all(rows), "Proposition 1 bound violated!"
    print("all bounds hold")


if __name__ == "__main__":
    main()
