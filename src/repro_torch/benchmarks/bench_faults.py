"""Sporadic participation against synchronous blocking under injected
faults, at an equal deployment-clock budget: the port of
``benchmarks/bench_faults.py``.

The deployment is the 8-node ring quadratic testbed with a deterministic
``repro_torch.faults.FaultPlan``: a node crash window, then a link-outage
window. Two policies ride the same fault timeline and the same budget:

  * ``blocking``: every node, every edge, every round. During a fault
    window the round still waits on the dead peer or link, so its gossip
    is priced through the ``edge_outage`` residual tariff.
  * ``sporadic``: the participation engine. Faulted nodes skip their
    local steps, faulted edges fold their weight onto the diagonal
    (``FaultPlan.masks`` -> ``[K, 2 + N + E]`` rows), and each round is
    priced by ``CostModel.masked_round_cost`` over the surviving sets.

Both run on one ``RoundExecutor(participation=True)`` (the blocking run is
the all-ones trajectory), which builds its round once: no build after the
warmup is asserted. The measured loss is the mean per-node global loss gap
``0.5 mean_i ||x_i - tbar||^2``. ``--check`` asserts that the sporadic run
reaches a lower loss than the blocking run; that is a convergence result,
so the port holds it by its sign, not by the reference's bits. The
gradient noise is drawn by numpy from each seed and carried in the
batches (the port's losses take no key).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_faults \\
        --smoke --check [--device cuda]

Writes ``results/repro_torch/bench_faults.json``.
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.benchmarks.common import save_result
from repro_torch.core import DFLConfig, RoundExecutor, init_state, ring
from repro_torch.device import resolve_device
from repro_torch.faults import FaultPlan, LinkOutage, NodeCrash
from repro_torch.optim import sgd
from repro_torch.planner import (ComputeModel, CostModel, LinkModel,
                                 WirelessLinks, edge_outage)

N = 8
DIM = 16
SIGMA = 0.5            # sampling-noise sigma (gradient = w - t_i - noise)
TSCALE = 0.8           # non-IID target spread
ETA = 0.008            # one shared lr: the comparison is about the policy
TAU1, TAU2 = 2, 1      # one shared schedule, likewise
T_GOSSIP = 1.0         # base gossip step cost (compute step = 1 unit)
RESIDUAL = 1e-2        # dead-link tariff: blocking gossip ~100x slower
BUDGET = 300.0
SUPERSTEP = 10
MAX_ROUNDS = 2000

# the fault timeline, in rounds (1 nominal round = TAU1 + TAU2 * T_GOSSIP
# = 3 deployment-clock units): a crash, then a link outage
CRASH = NodeCrash(node=3, r_start=5, r_stop=25)
OUTAGE = LinkOutage(edges=((0, 1), (4, 5)), r_start=40, r_stop=70)
SEC_PER_ROUND = float(TAU1 + TAU2 * T_GOSSIP)


def build_testbed() -> Tuple[CostModel, FaultPlan]:
    topo = ring(N)
    model_bits = 32.0 * DIM
    base_link = WirelessLinks(
        default=LinkModel(bytes_per_s=model_bits / 8.0 / T_GOSSIP))
    base = CostModel(compute=ComputeModel(step_flops=1.0, flops_per_s=1.0),
                     link=base_link, topology=topo, model_bits=model_bits)
    return base, FaultPlan(topo, (CRASH, OUTAGE), seed=0)


def blocking_schedule(base: CostModel, plan: FaultPlan,
                      budget: float) -> Tuple[int, float]:
    """Rounds the synchronous policy affords: any masked edge at the
    round's nominal index drags the whole round through the outage tariff
    (the fault windows run on the nominal clock)."""
    topo = base.topology
    clock, rounds = 0.0, 0
    while rounds < MAX_ROUNDS:
        _, em = plan.masks(int(clock // SEC_PER_ROUND))
        down = [e for e, m in zip(topo.edges(), em) if not m]
        cm = base
        if down:
            cm = CostModel(compute=base.compute,
                           link=edge_outage(base.link, down,
                                            residual=RESIDUAL),
                           topology=topo, model_bits=base.model_bits,
                           engine=base.engine)
        rc = cm.round_cost(TAU1, TAU2)
        if clock + rc.time_s > budget:
            break
        clock += rc.time_s
        rounds += 1
    return rounds, clock


def sporadic_schedule(base: CostModel, plan: FaultPlan,
                      budget: float) -> Tuple[np.ndarray, float]:
    """Masked rounds the sporadic policy affords, each priced over its
    surviving sets; the realized ``[K, 2 + N + E]`` rows and the clock."""
    topo = base.topology
    clock, rows = 0.0, []
    while len(rows) < MAX_ROUNDS:
        nm, em = plan.masks(int(clock // SEC_PER_ROUND))
        nodes = [i for i in range(topo.num_nodes) if nm[i]]
        edges = [e for e, m in zip(topo.edges(), em) if m]
        rc = base.masked_round_cost(TAU1, TAU2, active_nodes=nodes,
                                    active_edges=edges)
        if clock + rc.time_s > budget:
            break
        clock += rc.time_s
        rows.append(np.concatenate([np.array([TAU1, TAU2], np.int32), nm,
                                    em]))
    return np.asarray(rows, np.int32), clock


def quad_loss(p, b):
    return 0.5 * torch.sum((p["w"] - b) ** 2)


def run_trajectory(executor: RoundExecutor, rows: np.ndarray,
                   targets: np.ndarray, seed: int,
                   device: torch.device) -> float:
    """Run the (possibly masked) trajectory from w = 0; the final mean
    per-node global loss gap."""
    rng = np.random.default_rng(seed)
    state = init_state({"w": torch.zeros(DIM, device=device)}, N, sgd(ETA),
                       seed=seed)
    r = 0
    while r < len(rows):
        k = min(SUPERSTEP, len(rows) - r)
        noise = rng.normal(size=(k, TAU1, N, DIM)) * (SIGMA / np.sqrt(DIM))
        batches = torch.from_numpy(
            (targets[None, None] + noise).astype(np.float32)).to(device)
        state, _ = executor.dispatch_trajectory(state, batches,
                                                rows[r:r + k])
        r += k
    x = state.params["w"].cpu().numpy()
    return 0.5 * float(np.mean(np.sum((x - targets.mean(0)) ** 2, axis=1)))


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--smoke", action="store_true", help="2 seeds")
    ap.add_argument("--check", action="store_true",
                    help="assert that sporadic beats blocking at equal "
                         "budget")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="bench_faults")
    args = ap.parse_args(argv)
    seeds = 2 if args.smoke else args.seeds
    dev = resolve_device(args.device)

    base, plan = build_testbed()
    topo = base.topology
    targets = np.random.default_rng(0).normal(size=(N, DIM)) * TSCALE
    executor = RoundExecutor(DFLConfig(tau1=TAU1, tau2=TAU2, topology=topo),
                             quad_loss, sgd(ETA), participation=True)

    blk_rounds, blk_clock = blocking_schedule(base, plan, BUDGET)
    spo_rows, spo_clock = sporadic_schedule(base, plan, BUDGET)
    blk_rows = np.concatenate(
        [np.tile(np.array([[TAU1, TAU2]], np.int32), (blk_rounds, 1)),
         np.ones((blk_rounds, N + topo.num_edges), np.int32)], axis=1)
    degraded = int(sum(1 for row in spo_rows
                       if row[2:2 + N].sum() < N
                       or row[2 + N:].sum() < topo.num_edges))
    print(f"blocking: rounds={blk_rounds} priced_time={blk_clock:.1f}")
    print(f"sporadic: rounds={len(spo_rows)} priced_time={spo_clock:.1f} "
          f"degraded={degraded}")

    executor.warmup(init_state({"w": torch.zeros(DIM, device=dev)}, N,
                               sgd(ETA)),
                    torch.zeros((SUPERSTEP, TAU1, N, DIM), device=dev))
    warm_builds = executor.compile_count + executor.capture_count
    results: Dict[str, dict] = {}
    for name, rows, clock in (("blocking", blk_rows, blk_clock),
                              ("sporadic", spo_rows, spo_clock)):
        losses = [run_trajectory(executor, rows, targets, s, dev)
                  for s in range(seeds)]
        results[name] = {"rounds": len(rows), "priced_time": clock,
                         "loss": float(np.mean(losses)),
                         "loss_per_seed": [float(v) for v in losses]}
        print(f"{name}: loss={np.mean(losses):.4f}")
    blk_loss = results["blocking"]["loss"]
    spo_loss = results["sporadic"]["loss"]
    builds = executor.compile_count + executor.capture_count - warm_builds
    verdict = (f"WINS {blk_loss / spo_loss:.2f}x" if spo_loss < blk_loss
               else "LOSES")
    print(f"sporadic {verdict} vs blocking at budget={BUDGET} | builds "
          f"after warmup: {builds}")
    if builds:
        raise RuntimeError(f"{builds} builds after the warmup")
    payload = {
        "config": {"nodes": N, "dim": DIM, "sigma": SIGMA,
                   "target_scale": TSCALE, "eta": ETA, "tau1": TAU1,
                   "tau2": TAU2, "t_gossip": T_GOSSIP, "residual": RESIDUAL,
                   "budget": BUDGET, "superstep": SUPERSTEP, "seeds": seeds,
                   "smoke": args.smoke, "faults": plan.to_spec(),
                   "device": str(dev),
                   "device_name": (torch.cuda.get_device_name(dev)
                                   if dev.type == "cuda" else "cpu")},
        "blocking": results["blocking"],
        "sporadic": {**results["sporadic"], "degraded_rounds": degraded},
        "sporadic_beats_blocking": spo_loss < blk_loss,
        "margin_x": blk_loss / spo_loss if spo_loss > 0 else float("inf"),
        "builds_after_warmup": builds,
    }
    print(f"wrote {save_result(args.out, payload)}")
    if args.check:
        if not spo_loss < blk_loss:
            raise SystemExit(f"check failed: sporadic loss {spo_loss:.4f} "
                             f"does not beat blocking {blk_loss:.4f}")
        print("check OK: sporadic participation beats synchronous blocking "
              "at equal deployment-clock budget, no build after the warmup")
    return payload


if __name__ == "__main__":
    main()
