"""Schedule search: minimize the predicted bound under a resource budget.

``plan(budget, cost_model, sigma=..., f_gap=...)`` walks the
(tau1, tau2, compressor) grid; each candidate's per-round cost (from the
``CostModel``) converts the budget into an affordable round count, the
round count into a total iteration count T, and Proposition 1
(``bounds.predicted_loss_decrement``) into a predicted average gradient
norm — the candidate minimizing it wins. This is the paper's "convergence
rate ... optimized to achieve the balance of communication and computing
costs under constrained resources" (abstract / Sec. V) as an executable
object; ``repro_torch.benchmarks.bench_balance`` validates the picks
empirically.

Numpy only: a copy of ``repro.planner.optimize`` over the port's bounds and
cost models, so every plan is the reference's, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.compression import Compressor
from repro_torch.planner.bounds import (Availability, BoundEval,
                                  predicted_loss_decrement)
from repro_torch.planner.cost import CostModel, CostProcess, RoundCost

__all__ = [
    "DEFAULT_GRID",
    "Budget",
    "Plan",
    "TrajectoryPlan",
    "rounds_within",
    "evaluate_grid",
    "select_plan",
    "plan",
    "plan_trajectory",
]

DEFAULT_GRID: Tuple[Tuple[int, int], ...] = tuple(
    (t1, t2) for t1 in (1, 2, 4, 8, 16) for t2 in (1, 2, 4, 8))


@dataclasses.dataclass(frozen=True)
class Budget:
    """A resource envelope; any subset of currencies may be constrained.

    wall_clock_s: total seconds available.
    wire_bits: total wire bits per node available.
    energy_j: total joules per node available.
    """

    wall_clock_s: Optional[float] = None
    wire_bits: Optional[float] = None
    energy_j: Optional[float] = None

    def __post_init__(self):
        if (self.wall_clock_s is None and self.wire_bits is None
                and self.energy_j is None):
            raise ValueError("Budget needs at least one constrained resource")


@dataclasses.dataclass(frozen=True)
class Plan:
    """A planned schedule: the knobs plus the prediction that chose them."""

    tau1: int
    tau2: int
    compressor: Optional[Compressor]
    eta: float
    rounds: int
    total_iters: int
    predicted_bound: float
    round_cost: RoundCost
    bound_eval: BoundEval

    @property
    def compressor_name(self) -> str:
        return self.compressor.name if self.compressor is not None else "none"


def rounds_within(budget: Budget, rc: RoundCost) -> int:
    """Rounds affordable under every constrained currency (floor)."""
    limits: List[float] = []
    if budget.wall_clock_s is not None:
        limits.append(budget.wall_clock_s / rc.time_s if rc.time_s > 0
                      else float("inf"))
    if budget.wire_bits is not None:
        limits.append(budget.wire_bits / rc.wire_bits if rc.wire_bits > 0
                      else float("inf"))
    if budget.energy_j is not None:
        limits.append(budget.energy_j / rc.energy_j if rc.energy_j > 0
                      else float("inf"))
    lim = min(limits)
    return int(lim) if lim != float("inf") else 10**9


def evaluate_grid(
    budget: Budget,
    cost_model: CostModel,
    *,
    sigma: float,
    f_gap: float,
    grid: Sequence[Tuple[int, int]] = DEFAULT_GRID,
    compressors: Sequence[Optional[Compressor]] = (None,),
    gamma: float = 1.0,
    L: float = 1.0,
    eta: Optional[float] = None,
    availability: Optional[Availability] = None,
) -> List[Plan]:
    """Every feasible candidate as a Plan, in grid order (for tables).

    ``availability``: sporadic-participation rates forwarded to
    ``bounds.predicted_loss_decrement`` — degraded mixing, node-rate-scaled
    descent, and the tau2 = 0 drift credit that ranks outage rounds.

    An overlap-aware cost model (``cost_model.overlap == "pipeline"``)
    prices candidates on BOTH sides of the trade: the round cost uses the
    max-form round time (gossip hidden under compute), and the bound is
    charged the one-round-stale mixing penalty
    (``bounds.stale_mixing_zeta`` at staleness 1) — so the grid search
    weighs hidden wire time against slower mixing instead of getting the
    speedup for free.
    """
    topo = cost_model.topology
    model_dim = max(int(round(cost_model.model_bits / 32.0)), 1)
    staleness = 1.0 if cost_model.overlap == "pipeline" else 0.0
    out: List[Plan] = []
    for comp in compressors:
        for (t1, t2) in grid:
            rc = cost_model.round_cost(t1, t2, comp)
            r = rounds_within(budget, rc)
            if r < 1:
                continue
            T = r * (t1 + t2)
            ev = predicted_loss_decrement(
                t1, t2, topo, sigma, T=T, f_gap=f_gap, L=L, eta=eta,
                compressor=comp, gamma=gamma,
                model_dim=model_dim, availability=availability,
                staleness=staleness)
            out.append(Plan(tau1=t1, tau2=t2, compressor=comp, eta=ev.eta,
                            rounds=r, total_iters=T,
                            predicted_bound=ev.bound, round_cost=rc,
                            bound_eval=ev))
    return out


def select_plan(cands: Sequence[Plan]) -> Plan:
    """The winner among evaluated candidates — THE selection rule.

    Deterministic tie-breaking: lower predicted bound, then cheaper round
    time, then smaller (tau1, tau2) — so equal-bound candidates resolve
    stably across platforms. Callers that already hold an
    ``evaluate_grid`` result (for tables/reports) should select with this
    instead of re-running ``plan``.
    """
    if not cands:
        raise ValueError("no feasible schedule candidates to select from")
    return min(cands, key=lambda p: (p.predicted_bound, p.round_cost.time_s,
                                     p.tau1, p.tau2))


def plan(
    budget: Budget,
    cost_model: CostModel,
    *,
    sigma: float,
    f_gap: float,
    grid: Sequence[Tuple[int, int]] = DEFAULT_GRID,
    compressors: Sequence[Optional[Compressor]] = (None,),
    gamma: float = 1.0,
    L: float = 1.0,
    eta: Optional[float] = None,
    availability: Optional[Availability] = None,
) -> Plan:
    """The best feasible schedule under ``budget`` by predicted bound
    (``evaluate_grid`` then ``select_plan``)."""
    cands = evaluate_grid(
        budget, cost_model, sigma=sigma, f_gap=f_gap, grid=grid,
        compressors=compressors, gamma=gamma, L=L, eta=eta,
        availability=availability)
    if not cands:
        raise ValueError(
            f"no (tau1, tau2) grid point affords even one round in {budget}")
    return select_plan(cands)


# ---------------------------------------------------------------------------
# Per-round trajectories under time-varying costs (schedule as data)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrajectoryPlan:
    """A per-round schedule: ``steps[k]`` is the Plan chosen for round k.

    ``taus`` is the [K, 2] int32 array the fused executor consumes
    directly (``RoundExecutor.dispatch_trajectory``); the totals are the
    planner's PRICED spend over the whole trajectory (the simulated clock
    the episodes were evaluated against).
    """

    steps: Tuple[Plan, ...]
    total_time_s: float
    total_wire_bits: float
    total_energy_j: float

    @property
    def rounds(self) -> int:
        return len(self.steps)

    @property
    def taus(self) -> np.ndarray:
        return np.array([[p.tau1, p.tau2] for p in self.steps],
                        np.int32).reshape(-1, 2)

    @property
    def compressors(self) -> Tuple[Optional[Compressor], ...]:
        return tuple(p.compressor for p in self.steps)

    @property
    def tau_maxima(self) -> Tuple[int, int]:
        """(tau1_max, tau2_max) the executor must be compiled against."""
        if not self.steps:
            return (1, 0)
        return (max(p.tau1 for p in self.steps),
                max(p.tau2 for p in self.steps))


def _remaining(budget: Budget, t: float, bits: float,
               joules: float) -> Optional[Budget]:
    wall = (budget.wall_clock_s - t
            if budget.wall_clock_s is not None else None)
    wbits = (budget.wire_bits - bits
             if budget.wire_bits is not None else None)
    energy = (budget.energy_j - joules
              if budget.energy_j is not None else None)
    if any(rem is not None and rem <= 0.0
           for rem in (wall, wbits, energy)):
        return None
    return Budget(wall_clock_s=wall, wire_bits=wbits, energy_j=energy)


def plan_trajectory(
    budget: Budget,
    process: CostProcess,
    *,
    rounds: int,
    sigma: float,
    f_gap: float,
    grid: Sequence[Tuple[int, int]] = DEFAULT_GRID,
    compressors: Sequence[Optional[Compressor]] = (None,),
    gamma: float = 1.0,
    L: float = 1.0,
    eta: Optional[float] = None,
    availability: Optional[Availability] = None,
    t0: float = 0.0,
) -> TrajectoryPlan:
    """A per-round (tau1, tau2, compressor) trajectory of at most
    ``rounds`` rounds under a time-varying cost process.

    Receding-horizon rule: at round k, with the simulated deployment clock
    at t_k, the round's schedule is ``plan(remaining_budget,
    process.at(t_k))`` — the best fixed schedule if the rest of the run
    cost what this instant costs. Myopic by construction (a known future
    episode does not pre-shift the current round), but it is exactly the
    per-round adaptation of the resource-constrained wireless-DFL setting
    (Yan & Li arXiv:2308.06496): cheap links buy gossip-heavy rounds,
    straggler/fading/outage episodes shift the same budget toward local
    computation, and the clock advance prices each round at the tariff in
    force when it actually runs.

    A TIME-INVARIANT process degenerates EXACTLY to ``plan``: the fixed
    plan's schedule repeated min(plan.rounds, rounds) times (pinned by
    tests/test_planner.py). ``t0`` starts the deployment clock mid-process
    (the adaptive controller re-plans from its measured elapsed time).

    The trajectory ends early when the remaining budget affords no further
    round at the then-current tariff; an infeasible FIRST round raises
    ``ValueError`` like ``plan`` does.
    """
    assert rounds >= 1
    kw = dict(sigma=sigma, f_gap=f_gap, grid=grid, compressors=compressors,
              gamma=gamma, L=L, eta=eta, availability=availability)
    if process.is_static:   # t0 is irrelevant without episodes
        p = plan(budget, process.base, **kw)
        k = min(p.rounds, rounds)
        rc = p.round_cost
        return TrajectoryPlan(
            steps=(p,) * k,
            total_time_s=rc.time_s * k,
            total_wire_bits=rc.wire_bits * k,
            total_energy_j=rc.energy_j * k)
    steps: List[Plan] = []
    clock = float(t0)
    spent_bits = spent_j = 0.0
    remaining: Optional[Budget] = budget
    for _ in range(rounds):
        cm = process.at(clock)
        try:
            p = plan(remaining, cm, **kw)
        except ValueError:
            if not steps:
                raise
            break
        steps.append(p)
        rc = p.round_cost
        clock += rc.time_s
        spent_bits += rc.wire_bits
        spent_j += rc.energy_j
        remaining = _remaining(budget, clock - t0, spent_bits, spent_j)
        if remaining is None:
            break
    return TrajectoryPlan(
        steps=tuple(steps),
        total_time_s=clock - t0,
        total_wire_bits=spent_bits,
        total_energy_j=spent_j)
