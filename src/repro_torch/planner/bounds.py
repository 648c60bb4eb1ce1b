"""Proposition 1 / Proposition 2 of the paper as a reusable library.

The learning-rate condition (19), the convergence bound (20), and the
C-DFL (CHOCO) linear-convergence constants, plus
``predicted_loss_decrement`` — the bound evaluated the way the planner
consumes it (auto-chosen eta, optional compression-adjusted mixing).
``repro_torch.benchmarks.theory_check`` re-exports (19) and (20) beside
its quadratic simulation.

Numpy only: a copy of ``repro.planner.bounds`` with its imports pointed at
the port's ``core.compression`` and ``core.topology``, so every value is
the reference's, bit for bit.

Notation (paper Sec. II-III, Assumption 1): L-smooth objectives, stochastic
gradient variance sigma^2 measured against the GLOBAL gradient (so sigma
must include non-IID heterogeneity on top of sampling noise — see the
``repro_torch.benchmarks.theory_check`` docstring), doubly-stochastic
symmetric C with ``zeta = max{|lambda_2|, |lambda_N|} < 1``, rounds of tau1
local steps + tau2 gossip steps, T total iterations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.compression import Compressor
from repro_torch.core.topology import Topology

__all__ = [
    "lr_condition_19",
    "max_eta_19",
    "bound_20",
    "BoundEval",
    "predicted_loss_decrement",
    "choco_gamma_star",
    "cdfl_contraction",
    "effective_zeta",
    "Availability",
    "expected_mixing",
    "sampling_availability",
    "sporadic_zeta",
    "stale_mixing_zeta",
]


def _condition_19(eta: float, tau1: int, tau2: int, z: float,
                  L: float) -> bool:
    """Condition (19) with the mixing parameter passed as a scalar."""
    tau = tau1 + tau2
    if z >= 1.0 or (tau2 == 0 and z > 0.0):
        # zeta = 1 (disconnected components) never reaches consensus, and
        # tau2 = 0 with imperfect mixing never mixes AT ALL — as a
        # standing schedule both violate Assumption 1.6's premise, so no
        # eta > 0 qualifies. (Per-ROUND tau2 = 0 inside a trajectory is
        # fine; it is the never-gossip *policy* the bound rejects. NB the
        # scalar-z form can't distinguish a single node from a multi-node
        # graph whose zeta rounds to exactly 0.0 — the topology-aware
        # wrappers below guard on num_nodes > 1.)
        return eta <= 0.0
    if z == 0.0:
        lhs = eta * L + eta**2 * L**2 * tau * (tau - 1)
        return lhs <= 1.0
    lhs = eta * L + (eta**2 * L**2 * tau / (1 - z**tau2)) * (
        2 * tau1 * z ** (2 * tau2) / (1 + z**tau2)
        + 2 * tau1 * z**tau2 / (1 - z**tau2)
        + tau - 1)
    return lhs <= 1.0


def lr_condition_19(eta: float, tau1: int, tau2: int, topo: Topology,
                    L: float = 1.0, *, zeta: Optional[float] = None) -> bool:
    """Paper condition (19): eta small enough for bound (20) to hold.

    ``zeta`` overrides the topology's spectral value (used by the planner
    to price compression-degraded mixing, see ``effective_zeta``).
    """
    if tau2 == 0 and topo.num_nodes > 1:
        # never-gossip policy on a multi-node graph: no communication
        # steps at all, whatever the spectrum says (a complete graph's
        # zeta may compute to exactly 0.0 but tau2 = 0 never applies C).
        return eta <= 0.0
    z = topo.zeta if zeta is None else zeta
    return _condition_19(eta, tau1, tau2, z, L)


def max_eta_19(tau1: int, tau2: int, topo: Topology, L: float = 1.0, *,
               zeta: Optional[float] = None) -> float:
    """Largest eta satisfying condition (19), by bisection."""
    if tau2 == 0 and topo.num_nodes > 1:
        return 0.0   # see lr_condition_19: never-gossip admits no eta
    z = topo.zeta if zeta is None else zeta
    lo, hi = 0.0, 1.0 / L
    for _ in range(60):
        mid = (lo + hi) / 2
        if _condition_19(mid, tau1, tau2, z, L):
            lo = mid
        else:
            hi = mid
    return lo


def bound_20(eta: float, tau1: int, tau2: int, topo: Topology, T: int,
             f_gap: float, sigma: float, n: int, L: float = 1.0, *,
             zeta: Optional[float] = None) -> float:
    """Paper bound (20) on E[(1/T) sum_t ||nabla F(u_t)||^2]:

        2 (F(u_1) - F_inf) / (eta T)  +  eta L sigma^2 / n  +  drift,
        drift = 2 eta^2 L^2 sigma^2 (tau1 / (1 - zeta^(2 tau2)) - 1).
    """
    z = topo.zeta if zeta is None else zeta
    if z >= 1.0 or (tau2 == 0 and n > 1):
        # Assumption 1.6 violated, or no communication steps at all on a
        # multi-node graph: no finite bound.
        return float("inf")
    drift = 2 * eta**2 * L**2 * sigma**2 * (tau1 / (1 - z ** (2 * tau2)) - 1
                                            if z > 0 else tau1 - 1)
    return 2 * f_gap / (eta * T) + eta * L * sigma**2 / n + drift


@dataclasses.dataclass(frozen=True)
class Availability:
    """Sporadic-participation rates for planning degraded rounds.

    node_rate / edge_rate: the fraction of nodes doing local updates and
    of edges carrying gossip in a typical round (estimated online by
    ``planner.adaptive.AdaptiveController.observe_participation`` or read
    off a ``repro_torch.faults.FaultPlan``).

    resume_tau2: how many gossip steps a round is EXPECTED to run once
    connectivity returns (>= its long-run average). It is the drift
    credit for pricing a tau2 = 0 outage round: instead of the
    paper-faithful infinite bound (a standing never-gossip schedule),
    the sporadic bound charges the round the drift of a schedule that
    gossips ``resume_tau2`` steps per round — finite, so the planner can
    RANK compute-only candidates by how much drift they bank rather
    than falling through to the tie-break.
    """

    node_rate: float = 1.0
    edge_rate: float = 1.0
    resume_tau2: float = 1.0

    def __post_init__(self):
        for name in ("node_rate", "edge_rate"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.resume_tau2 < 0.0:
            raise ValueError(
                f"resume_tau2 must be >= 0, got {self.resume_tau2}")

    @property
    def is_full(self) -> bool:
        return self.node_rate >= 1.0 and self.edge_rate >= 1.0


def sampling_availability(population: int, cohort: int, *,
                          resume_tau2: float = 1.0) -> Availability:
    """Price cohort sampling as participation: sampling rate C/V IS the
    participation rate.

    A round that activates a uniformly-drawn C-of-V cohort does local
    work on a C/V fraction of the population and carries gossip on a
    C/V fraction of its (virtual) edges, so the batched engine's sampled
    rounds are planned with the SAME ``Availability`` machinery as
    sporadic participation — ``predicted_loss_decrement(...,
    availability=sampling_availability(V, C))`` engages ``sporadic_zeta``
    exactly as a Bernoulli(C/V) fault plan would. At full participation
    (``cohort == population``) the result ``is_full``, so the bound
    degenerates EXACTLY to the deterministic Proposition-1 evaluation
    (tests/test_planner.py pins the analogous mask degeneration).
    """
    if not (1 <= cohort <= population):
        raise ValueError(
            f"need 1 <= cohort <= population, got cohort={cohort} "
            f"population={population}")
    rate = cohort / population
    return Availability(node_rate=rate, edge_rate=rate,
                        resume_tau2=resume_tau2)


def expected_mixing(topology: Topology, edge_rate: float) -> np.ndarray:
    """E[C_masked] under i.i.d. Bernoulli(edge_rate) edge participation.

    Each off-diagonal weight survives w.p. ``edge_rate``; a masked edge's
    weight folds onto BOTH endpoints' diagonals
    (``core.mixing.masked_mixing_matrix``), so in expectation the
    diagonal absorbs the complementary mass and the matrix stays
    symmetric doubly stochastic.
    """
    if not (0.0 <= edge_rate <= 1.0):
        raise ValueError(f"edge_rate must be in [0, 1], got {edge_rate}")
    cm = np.asarray(topology.mixing, dtype=np.float64)
    off = cm - np.diag(np.diag(cm))
    exp = off * edge_rate
    return exp + np.diag(1.0 - exp.sum(axis=0))


def sporadic_zeta(topology: Topology, edge_rate: float) -> float:
    """zeta of the EXPECTED masked mixing matrix: the planning-grade
    mixing parameter of sporadic gossip (slower mixing as edges drop;
    exact spectral zeta at edge_rate = 1). Heuristic in the same spirit
    as ``effective_zeta`` — E[zeta(C_masked)] >= zeta(E[C_masked]) by
    convexity, so this flatters mixing slightly; it ranks schedules, it
    does not certify them.
    """
    if topology.num_nodes <= 1:
        return 0.0
    from repro_torch.core.topology import zeta as spectral_zeta
    return float(min(1.0, spectral_zeta(expected_mixing(topology,
                                                        edge_rate))))


def stale_mixing_zeta(topology: Topology, staleness: float) -> float:
    """Planning-grade mixing parameter of S-round-STALE gossip.

    The pipelined executor (``RoundExecutor(overlap="pipeline")``) folds
    round k's gossip exchange into the parameters one round late: each
    mixing application contracts consensus error measured against state
    that is ``staleness`` rounds old (here always 1). The delayed-gossip
    analyses (DSpodFL arXiv:2402.03448; DFedAvg-style arXiv:2104.11375)
    show the effect is a DILUTED mixing operator: over 1 + S rounds only
    one round's worth of fresh contraction lands, i.e. the time-average
    mixing matrix is the expected masked matrix with participation rate
    1 / (1 + S). We therefore price staleness with the machinery already
    trusted for sporadic gossip:

        stale_mixing_zeta(G, S) = sporadic_zeta(G, edge_rate=1/(1+S))

    Exact at S = 0 (every edge fresh: edge_rate 1 recovers the spectral
    zeta); monotonically worse as S grows. Like ``sporadic_zeta`` this
    ranks schedules rather than certifying them.
    """
    if staleness < 0.0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    return sporadic_zeta(topology, 1.0 / (1.0 + staleness))


@dataclasses.dataclass(frozen=True)
class BoundEval:
    """One evaluation of the planning objective: the value, its eta, and
    the three terms (optimization / statistical / local-drift)."""

    bound: float
    eta: float
    opt_term: float
    stat_term: float
    drift_term: float
    zeta: float


def predicted_loss_decrement(
    tau1: int,
    tau2: int,
    topology: Topology,
    sigma: float,
    *,
    T: int,
    f_gap: float,
    n: Optional[int] = None,
    L: float = 1.0,
    eta: Optional[float] = None,
    compressor: Optional[Compressor] = None,
    gamma: float = 1.0,
    model_dim: int = 1024,
    availability: Optional[Availability] = None,
    staleness: float = 0.0,
) -> BoundEval:
    """The planner's objective: bound (20) sharpened for prediction.

    Two deliberate departures from the paper-faithful certificate
    ``bound_20`` (which stays available, and is what
    ``repro_torch.benchmarks.theory_check`` verifies):

      * the optimization term counts DESCENT iterations only
        (T * tau1 / (tau1 + tau2)): bound (20)'s 1/(eta T) with total T
        credits gossip iterations with gradient progress, which makes
        comm-heavy schedules look free and mis-ranks them against
        measurement (validated on the quadratic testbed in
        tests/test_planner.py);
      * with ``eta=None`` the learning rate is chosen to MINIMIZE the
        objective over (0, max_eta_19] (log grid) — the paper's
        "convergence rate ... can be optimized" applies to eta too, and
        each grid candidate is compared at its own best rate.

    With a ``compressor`` the mixing parameter is degraded to
    ``effective_zeta`` (CHOCO gossip mixes slower per step; Prop. 2's
    mechanism) — a planning heuristic rather than a proved bound.

    With an ``availability`` (the sporadic-participation regime) three
    further planning-grade adjustments apply, all degenerating to the
    exact formulas at full participation:

      * mixing degrades to ``sporadic_zeta`` (the zeta of the expected
        masked mixing matrix) — never better than the exact zeta;
      * descent iterations and the variance-averaging population scale
        by ``node_rate`` (only participating nodes step / contribute);
      * a tau2 = 0 round is charged the drift of a schedule gossiping
        ``resume_tau2`` steps per round instead of going infinite, so
        outage rounds are RANKED by drift credit (see ``Availability``).

    ``staleness`` > 0 prices the pipelined executor's one-round-stale
    mixing (``overlap="pipeline"`` folds gossip in one round late):
    mixing degrades to ``stale_mixing_zeta`` — never better than the
    fresh zeta, exact at staleness 0. The planner sets it from the cost
    model's overlap mode so the overlap-aware round-time win is weighed
    against its convergence penalty on the same grid.
    """
    n = topology.num_nodes if n is None else n
    if compressor is None:
        z = effective_zeta(topology)
    else:
        z = effective_zeta(topology, delta=compressor.delta(model_dim),
                           gamma=gamma)
    if staleness > 0.0 and n > 1:
        z = float(min(1.0 - 1e-12,
                      max(z, stale_mixing_zeta(topology, staleness))))
    avail = availability
    if avail is not None and avail.is_full:
        avail = None
    if avail is not None and avail.edge_rate < 1.0 and n > 1:
        z = float(min(1.0 - 1e-12,
                      max(z, sporadic_zeta(topology, avail.edge_rate))))
    node_rate = 1.0 if avail is None else max(avail.node_rate, 1.0 / n)
    tau2_eff: float = float(tau2)
    if tau2 == 0 and avail is not None and avail.resume_tau2 > 0.0:
        tau2_eff = float(avail.resume_tau2)
    t_descent = T * tau1 / (tau1 + tau2) * node_rate
    if T <= 0 or t_descent <= 0 or z >= 1.0 or (tau2_eff == 0 and n > 1):
        # tau2 = 0 on a non-complete graph: a standing never-gossip
        # schedule has unbounded drift. Without an availability's drift
        # credit it stays a valid LAST-RESORT grid point for per-round
        # trajectory planning (an outage round that only computes): with
        # every bound infinite, ``select_plan``'s deterministic tie-break
        # (round time, then taus) chooses among the compute-only
        # candidates.
        return BoundEval(bound=float("inf"), eta=float(eta or 0.0),
                         opt_term=float("inf"), stat_term=0.0,
                         drift_term=0.0, zeta=z)
    n_eff = n * node_rate
    drift_coeff = 2 * L**2 * sigma**2 * (
        tau1 / (1 - z ** (2 * tau2_eff)) - 1 if z > 0 else tau1 - 1)

    def terms(e: float):
        return (2 * f_gap / (e * t_descent), e * L * sigma**2 / n_eff,
                e**2 * drift_coeff)

    if eta is None:
        emax = max_eta_19(tau1, tau2 if tau2 > 0 else tau2_eff, topology,
                          L, zeta=z)
        cands = emax * np.logspace(-3.0, 0.0, 64)
        eta = float(min(cands, key=lambda e: sum(terms(e))))
    elif eta <= 0.0:
        return BoundEval(bound=float("inf"), eta=float(eta),
                         opt_term=float("inf"), stat_term=0.0,
                         drift_term=0.0, zeta=z)
    opt, stat, drift = terms(float(eta))
    return BoundEval(bound=opt + stat + drift, eta=float(eta), opt_term=opt,
                     stat_term=stat, drift_term=drift, zeta=z)


# ---------------------------------------------------------------------------
# C-DFL (Proposition 2 / CHOCO) linear-convergence constants
# ---------------------------------------------------------------------------


def choco_gamma_star(topology: Topology, delta: float) -> float:
    """The CHOCO-Gossip consensus step size gamma* the C-DFL linear rate
    (Prop. 2) is stated with (Koloskova et al. 2019, Lemma A.3):

        gamma* = rho^2 delta / (16 rho + rho^2 + 4 beta^2
                                + 2 rho beta^2 - 8 rho delta)

    with rho = 1 - zeta the spectral gap, beta = ||I - C||_2, and delta the
    compression ratio of Assumption 2.
    """
    rho = topology.spectral_gap
    b = topology.beta
    denom = 16 * rho + rho**2 + 4 * b**2 + 2 * rho * b**2 - 8 * rho * delta
    if denom <= 0.0:
        return 1.0
    return rho**2 * delta / denom


def cdfl_contraction(topology: Topology, delta: float,
                     gamma: Optional[float] = None) -> float:
    """Per-gossip-step consensus contraction factor under CHOCO-G.

    At gamma = gamma* the CHOCO analysis contracts the consensus error by
    (1 - rho^2 delta / 16) per step — the constant behind C-DFL's linear
    convergence for strongly convex objectives (Prop. 2). For a smaller
    gamma the contraction degrades proportionally; tau2 steps contract by
    this factor to the tau2-th power.
    """
    rho = topology.spectral_gap
    full = rho**2 * delta / 16.0
    if gamma is None:
        return max(0.0, min(1.0, 1.0 - full))
    gstar = choco_gamma_star(topology, delta)
    frac = min(1.0, gamma / gstar) if gstar > 0 else 1.0
    return max(0.0, min(1.0, 1.0 - frac * full))


def effective_zeta(topology: Topology, delta: float = 1.0,
                   gamma: Optional[float] = None) -> float:
    """Mixing parameter to plug into the Prop-1 formulas for a schedule.

    Uncompressed gossip (delta = 1, gamma unset) mixes with the exact
    spectral zeta. CHOCO-compressed gossip contracts the consensus
    *squared* error by ``cdfl_contraction`` per step, so the per-step
    amplitude factor is its square root — never better than the exact zeta
    (compression cannot speed mixing up). A planning-grade bridge between
    Prop. 1 and Prop. 2, not a proved bound.
    """
    z = topology.zeta
    if delta >= 1.0 and gamma is None:
        return z
    c = cdfl_contraction(topology, delta, gamma)
    return float(min(1.0 - 1e-12, max(z, np.sqrt(c))))
