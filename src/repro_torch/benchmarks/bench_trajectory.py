"""Per-round (tau1, tau2) trajectories vs. every fixed schedule, at equal
budget, under straggler/fading episodes — the schedule-as-data payoff. The
port of ``benchmarks/bench_trajectory.py``.

The deployment is the 8-node ring quadratic testbed with a TIME-VARYING
cost process (``planner.cost.CostProcess``): link episodes priced via
``WirelessLinks.per_edge`` make gossip ~1000x more expensive during two
windows (one straggling node gating the synchronous gossip step, one
network-wide deep fade). Every run is charged on the same simulated
deployment clock and stopped at the same wall-clock budget:

  * ``fixed``      — each (tau1, tau2) grid point run unchanged through
                     the episodes (a fixed schedule keeps paying the
                     episode tariff: that is the cost of schedule-as-
                     control-flow).
  * ``trajectory`` — ``planner.optimize.plan_trajectory`` walks the same
                     clock and re-plans EVERY ROUND from the remaining
                     budget and the tariff in force: gossip rounds while
                     links are good, compute-only (tau2 = 0) rounds
                     through the outages, gossip again after.

All runs execute for real on ``RoundExecutor`` — the fixed grid and the
trajectory alike as [K, 2] ``dispatch_trajectory`` supersteps — through ONE
executor built at the grid's maxima, so the whole sweep (every schedule,
every seed) replays the step graphs captured in its warmup: no build and no
capture after the warmup is asserted on every run (the reference asserts
zero recompiles). On the card every gossip step is one K1 launch. The
headline (asserted under ``--check``): the trajectory's measured loss at
budget beats EVERY fixed grid point's.

The measured loss is the mean per-node global loss gap
mean_i F(x_i) - F* = 0.5 mean_i ||x_i - tbar||^2 (what each node actually
deploys — it charges both average-model error and residual consensus
drift, so under- and over-gossiping both lose). One shared learning rate
for every run keeps the comparison purely about the schedule. The
gradient noise is drawn by numpy from each seed and carried in the
batches, as in the reference, so the CPU and the card run the same data.

Writes ``results/repro_torch/bench_trajectory.json`` (``--out`` to
override). ``--smoke`` drops to 2 seeds.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_trajectory \\
        --smoke --check [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.benchmarks.common import RESULTS_DIR
from repro_torch.core import DFLConfig, RoundExecutor, init_state, ring
from repro_torch.device import resolve_device
from repro_torch.optim import sgd
from repro_torch.planner import (Budget, ComputeModel, CostModel, CostProcess,
                                 Episode, LinkModel, TrajectoryPlan,
                                 WirelessLinks, faded_links, plan_trajectory,
                                 straggler_links)

DEFAULT_OUT = os.path.join(RESULTS_DIR, "bench_trajectory.json")

N = 8
DIM = 16
SIGMA = 0.5            # sampling-noise sigma (gradient = w - t_i - noise)
TSCALE = 0.8           # non-IID target spread
ETA = 0.008            # one shared lr: the comparison is about schedules
GRID = [(1, 2), (2, 2), (2, 1), (4, 1), (8, 1), (16, 1),
        (1, 0), (4, 0), (16, 0)]   # tau2=0: the outage escape hatches
T_GOSSIP = 1.0         # base gossip step cost (compute step = 1 unit)
SLOWDOWN = 1000.0      # episode link degradation (outage-severity)
EPISODES = ((100.0, 220.0, "straggler"), (300.0, 420.0, "fade"))
BUDGET = 500.0
SUPERSTEP = 10
MAX_ROUNDS = 3000
TAU1_MAX = max(t1 for t1, _ in GRID)
TAU2_MAX = max(t2 for _, t2 in GRID)

Dispatch = Callable[..., Tuple[object, dict]]


def build_process() -> CostProcess:
    """The straggler/fading scenario priced via WirelessLinks.per_edge."""
    topo = ring(N)
    model_bits = 32.0 * DIM
    copy_bytes = model_bits / 8.0
    base_link = WirelessLinks(
        default=LinkModel(bytes_per_s=copy_bytes / T_GOSSIP))
    episodes = []
    for (t0, t1, kind) in EPISODES:
        if kind == "straggler":
            link = straggler_links(base_link, topo, 0, SLOWDOWN)
        else:
            link = faded_links(base_link, SLOWDOWN)
        episodes.append(Episode(t0, t1, link=link, label=kind))
    base = CostModel(compute=ComputeModel(step_flops=1.0, flops_per_s=1.0),
                     link=base_link, topology=topo, model_bits=model_bits)
    return CostProcess(base=base, episodes=tuple(episodes))


def testbed_targets() -> np.ndarray:
    """The node targets t_i of the testbed (numpy seed 0)."""
    return np.random.default_rng(0).normal(size=(N, DIM)) * TSCALE


def testbed_constants(targets: np.ndarray) -> Tuple[float, float]:
    """(f_gap, effective sigma) — Assumption 1.5 sigma includes the
    non-IID heterogeneity (see ``theory_check``)."""
    tbar = targets.mean(0)
    f_gap = 0.5 * float(np.sum(tbar ** 2))
    sig_eff = float(np.sqrt(
        SIGMA ** 2 + np.max(np.sum((targets - tbar) ** 2, axis=1))))
    return f_gap, sig_eff


def plan(process: CostProcess, targets: np.ndarray) -> TrajectoryPlan:
    """The planner's per-round trajectory over the whole budget."""
    f_gap, sig_eff = testbed_constants(targets)
    return plan_trajectory(Budget(wall_clock_s=BUDGET), process,
                           rounds=MAX_ROUNDS, sigma=sig_eff, f_gap=f_gap,
                           grid=GRID, eta=ETA)


def fixed_schedule(process: CostProcess, budget: float, t1: int,
                   t2: int) -> Tuple[List[Tuple[int, int]], float]:
    """The rounds a fixed (t1, t2) affords: walk the deployment clock,
    each round priced at the tariff in force when it starts."""
    clock = 0.0
    taus: List[Tuple[int, int]] = []
    while len(taus) < MAX_ROUNDS:
        rc = process.at(clock).round_cost(t1, t2)
        if clock + rc.time_s > budget:
            break
        clock += rc.time_s
        taus.append((t1, t2))
    return taus, clock


def quad_loss(p, b):
    return 0.5 * torch.sum((p["w"] - b) ** 2)


def make_executor() -> RoundExecutor:
    """One executor at the grid's maxima: every schedule of the sweep."""
    return RoundExecutor(
        DFLConfig(tau1=TAU1_MAX, tau2=TAU2_MAX, topology=ring(N)),
        quad_loss, sgd(ETA))


def run_schedule(executor: RoundExecutor, taus: List[Tuple[int, int]],
                 targets: np.ndarray, seed: int, tau1_max: int, opt,
                 device, dispatch: Optional[Dispatch] = None) -> float:
    """Execute the schedule on the executor (heterogeneous [K, 2] chunks of
    at most ``SUPERSTEP`` rounds) from w = 0 and return the final mean
    per-node global loss gap. ``dispatch(state, batches, chunk)`` replaces
    ``executor.dispatch_trajectory``."""
    dev = resolve_device(device)
    dispatch = dispatch or executor.dispatch_trajectory
    rng = np.random.default_rng(seed)
    state = init_state({"w": torch.zeros(DIM, device=dev)}, N, opt,
                       seed=seed)
    r = 0
    while r < len(taus):
        k = min(SUPERSTEP, len(taus) - r)
        chunk = np.asarray(taus[r:r + k], np.int32)
        # batches row t of round k: target + noise (the stochastic
        # gradient's noise lives in the data; rows >= tau1 never read).
        noise = rng.normal(size=(k, tau1_max, N, DIM)) * (SIGMA / np.sqrt(DIM))
        batches = torch.from_numpy(
            (targets[None, None] + noise).astype(np.float32)).to(dev)
        state, _ = dispatch(state, batches, chunk)
        r += k
    x = state.params["w"].cpu().numpy()
    tbar = targets.mean(0)
    return 0.5 * float(np.mean(np.sum((x - tbar) ** 2, axis=1)))


def main(argv=None, dispatch: Optional[Callable] = None) -> Dict:
    """Run the sweep; returns the payload it writes. ``dispatch(executor,
    state, batches, chunk)``, when given, runs every dispatch instead of
    ``executor.dispatch_trajectory`` (a caller's instrumentation)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--smoke", action="store_true", help="2 seeds")
    ap.add_argument("--check", action="store_true",
                    help="assert the trajectory beats every fixed grid "
                         "point's measured loss at budget")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    seeds = 2 if args.smoke else args.seeds
    dev = resolve_device(args.device)

    process = build_process()
    targets = testbed_targets()
    opt = sgd(ETA)
    executor = make_executor()
    run_dispatch = (None if dispatch is None else
                    lambda st, b, c: dispatch(executor, st, b, c))

    def run(taus, seed):
        return run_schedule(executor, taus, targets, seed, TAU1_MAX, opt,
                            dev, run_dispatch)

    # -- plan ---------------------------------------------------------------
    tp = plan(process, targets)
    traj = [tuple(map(int, row)) for row in tp.taus]
    fixed = {(t1, t2): fixed_schedule(process, BUDGET, t1, t2)
             for (t1, t2) in GRID}

    # -- warm (build the round, capture its steps), then measure ------------
    executor.warmup(init_state({"w": torch.zeros(DIM, device=dev)}, N, opt),
                    torch.zeros((SUPERSTEP, TAU1_MAX, N, DIM), device=dev))
    warm = (executor.compile_count, executor.capture_count)

    results: Dict[str, dict] = {}
    for (t1, t2), (taus, clock) in fixed.items():
        losses = [run(taus, s) for s in range(seeds)]
        results[f"{t1},{t2}"] = {
            "tau1": t1, "tau2": t2, "rounds": len(taus),
            "priced_time": clock, "loss": float(np.mean(losses)),
            "loss_per_seed": [float(v) for v in losses],
        }
        print(f"fixed ({t1:2d},{t2}): rounds={len(taus):4d} "
              f"time={clock:6.1f} loss={np.mean(losses):.4f}")

    traj_losses = [run(traj, s) for s in range(seeds)]
    traj_loss = float(np.mean(traj_losses))
    counts = Counter(traj)
    print(f"trajectory: rounds={len(traj)} time={tp.total_time_s:6.1f} "
          f"loss={traj_loss:.4f} schedule={dict(counts)}")

    best_key = min(results, key=lambda k: results[k]["loss"])
    best_loss = results[best_key]["loss"]
    builds = executor.compile_count - warm[0]
    captures = executor.capture_count - warm[1]
    verdict = (f"WINS {best_loss / traj_loss:.2f}x" if traj_loss < best_loss
               else "LOSES")
    print(f"best fixed: ({best_key}) loss={best_loss:.4f} -> trajectory "
          f"{verdict} | builds after warmup: {builds}, captures: {captures}")

    # the whole sweep — every fixed schedule, every seed, and the
    # heterogeneous trajectory — replayed the warmup's build and graphs
    if builds or captures:
        raise RuntimeError(f"{builds} builds and {captures} captures after "
                           "the warmup across the sweep")

    payload = {
        "config": {
            "nodes": N, "dim": DIM, "sigma": SIGMA, "target_scale": TSCALE,
            "eta": ETA, "grid": [list(g) for g in GRID],
            "t_gossip": T_GOSSIP, "slowdown": SLOWDOWN,
            "episodes": [list(e) for e in EPISODES], "budget": BUDGET,
            "superstep": SUPERSTEP, "seeds": seeds, "smoke": args.smoke,
            "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
        },
        "fixed": results,
        "trajectory": {
            "rounds": len(traj), "priced_time": tp.total_time_s,
            "loss": traj_loss,
            "loss_per_seed": [float(v) for v in traj_losses],
            "schedule_counts": {f"{a},{b}": c for (a, b), c in
                                counts.items()},
            "schedule": [list(t) for t in traj],
        },
        "best_fixed": {"key": best_key, "loss": best_loss},
        "trajectory_beats_best_fixed": traj_loss < best_loss,
        "margin_x": best_loss / traj_loss if traj_loss > 0 else float("inf"),
        "builds_after_warmup": builds,
        "captures_after_warmup": captures,
        "compile_count_warmup": warm[0],
        "capture_count_warmup": warm[1],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {args.out}")
    if args.check:
        if not traj_loss < best_loss:
            raise SystemExit(f"check failed: trajectory loss {traj_loss:.4f} "
                             f"does not beat best fixed ({best_key}) "
                             f"{best_loss:.4f}")
        print("check OK: trajectory beats every fixed grid point at "
              "budget, no build or capture after the warmup")
    return payload


if __name__ == "__main__":
    main()
