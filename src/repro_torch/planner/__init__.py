"""Resource-constrained schedule planner (the paper's Sec. V trade-off as a
reusable subsystem), ported from ``repro.planner``.

The paper's headline claim — "the convergence rate of DFL can be optimized
to achieve the balance of communication and computing costs under
constrained resources" (abstract) — in four modules:

  * ``planner.cost``     — per-round wall-clock / energy / wire-bit cost
                           models, priced per engine and per compressor,
                           with an optional wireless per-edge link model.
  * ``planner.bounds``   — Proposition 1 as a library: learning-rate
                           condition (19), bound (20), the C-DFL/CHOCO
                           linear-convergence constants, the sporadic and
                           stale zeta, and ``predicted_loss_decrement``.
  * ``planner.optimize`` — ``plan(budget, cost_model, ...)`` and
                           ``plan_trajectory``: search the (tau1, tau2,
                           compressor) grid for the schedule minimizing the
                           predicted bound within a budget.
  * ``planner.adaptive`` — a runtime controller that re-fits the cost model
                           from *measured* round timings and re-plans
                           (``repro_torch.launch.planned_run`` drives the
                           executor from it).

All four are numpy only, copies of the reference's with their imports
pointed at the port (``core.compression``, ``core.topology``), so the same
inputs give the reference's values bit for bit; the card's work is in the
drivers that execute the plans. ``repro_torch.benchmarks.theory_check``
validates the bounds numerically and ``bench_balance`` / ``bench_trajectory``
the planner's picks empirically.
"""
from repro_torch.planner.cost import (
    ComputeModel,
    CostModel,
    CostProcess,
    Episode,
    LinkModel,
    RoundCost,
    WirelessLinks,
    comm_compute_cost,
    edge_outage,
    faded_links,
    straggler_links,
    unit_cost_model,
    wireless_link,
)
from repro_torch.planner.bounds import (
    Availability,
    BoundEval,
    bound_20,
    cdfl_contraction,
    choco_gamma_star,
    effective_zeta,
    lr_condition_19,
    max_eta_19,
    predicted_loss_decrement,
    sampling_availability,
    sporadic_zeta,
    stale_mixing_zeta,
)
from repro_torch.planner.optimize import (
    DEFAULT_GRID,
    Budget,
    Plan,
    TrajectoryPlan,
    evaluate_grid,
    plan,
    plan_trajectory,
    rounds_within,
    select_plan,
)
from repro_torch.planner.adaptive import AdaptiveController

__all__ = [
    "ComputeModel", "CostModel", "CostProcess", "Episode", "LinkModel",
    "RoundCost", "WirelessLinks",
    "comm_compute_cost", "edge_outage", "faded_links", "straggler_links",
    "unit_cost_model", "wireless_link",
    "Availability", "BoundEval", "bound_20", "cdfl_contraction",
    "choco_gamma_star", "effective_zeta", "lr_condition_19", "max_eta_19",
    "predicted_loss_decrement", "sampling_availability", "sporadic_zeta",
    "stale_mixing_zeta",
    "DEFAULT_GRID", "Budget", "Plan", "TrajectoryPlan", "evaluate_grid",
    "plan", "plan_trajectory", "rounds_within", "select_plan",
    "AdaptiveController",
]
