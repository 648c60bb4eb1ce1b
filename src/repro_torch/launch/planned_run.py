"""The adaptive planner driving the round executor: the trajectory-mode
loop of the reference's ``launch/train.py`` (``--schedule trajectory``) on
the port's ``RoundExecutor``, closed from measured timings to schedules.

``run_planned`` runs one session under an ``AdaptiveController``'s budget.
For each superstep of at most ``superstep`` rounds:

  1. ``next_trajectory(k)`` re-fits the per-step compute and gossip seconds
     from every measured chunk and plans the next k rounds (a probe rides
     the chunk's last round while the fit is rank-deficient); None ends
     the session (budget exhausted).
  2. The chunk's host batches are copied to the device: built on a worker
     thread while the card ran the previous chunk (``HostPrefetcher``), at
     a guess of every round's tau1 (the previous chunk's largest), or
     rebuilt when a round's planned tau1 exceeds the guess (a stale
     prefetch). A chunk length not dispatched before is warmed
     (``executor.warmup``). The stall, the copy and the warmup are charged
     to the budget through ``spend_overhead``, outside the fit.
  3. The dispatch is timed on the host clock and ended by its one device
     sync; ``observe_chunk`` enters (sum tau1, sum tau2, seconds) into the
     fit.

Round r's batches at tau1 steps are the first tau1 steps of its batches at
any larger tau1 (``round_batches(r, tau1)`` must keep that), so a prefetch
built at the guess serves any plan at or below it. The chunk's batch leaves
are ``[k, T, ...]`` with T the chunk's largest tau1, not the executor's
``tau1_max``: the dense executor reads only round i's first tau1 steps, and
a round at tau1 = 1 then copies one step's batch, not sixteen. The set-up
before the loop (the executor's warmup, which builds the round and
captures its step graphs on the card) is not charged: the budget covers
the training loop. The
executor must be built at the grid's maxima (``DEFAULT_GRID``: (16, 8)),
as the reference's ``train.py`` does, so that no re-plan asks for a tau the
graphs were not sized for; ``builds_after_warmup`` and
``captures_after_warmup`` in the result must stay 0.

``cnn_planned_run`` sets the paper's CNN up this way (the reference's
neutral prior: one second a local step and a gossip step,
``unit_cost_model(ring, 1.0, rep_dim=model_bits // 32)``) and runs it::

    PYTHONPATH=src python -m repro_torch.launch.planned_run --flavor cifar \\
        --compression qsgd --budget 2 --superstep 4 [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compression import Identity, make_compressor, \
    tree_wire_bits
from repro_torch.core.dfl import DFLConfig, DFLState, init_state
from repro_torch.core.executor import HostPrefetcher, RoundExecutor
from repro_torch.core.topology import ring
from repro_torch.core.tree import tree_map
from repro_torch.data.images import image_batches_for_dfl
from repro_torch.device import resolve_device, to_device
from repro_torch.launch.cnn_run import get_data
from repro_torch.models.cnn import cnn_loss, init_cnn
from repro_torch.optim import sgd
from repro_torch.planner import (DEFAULT_GRID, AdaptiveController, Budget,
                                 unit_cost_model)

__all__ = ["run_planned", "cnn_planned_run", "main"]

Dispatch = Callable[[RoundExecutor, DFLState, Any, np.ndarray],
                    Tuple[DFLState, dict]]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_planned(executor: RoundExecutor, controller: AdaptiveController,
                state: DFLState, round_batches: Callable[[int, int], Any], *,
                superstep: int, device="cuda",
                dispatch: Optional[Dispatch] = None
                ) -> Tuple[DFLState, Dict]:
    """Run rounds planned by ``controller`` on ``executor`` until its budget
    is spent. ``round_batches(r, tau1)`` is round r's
    host batch tree at tau1 steps (numpy leaves ``[tau1, ...]``);
    ``dispatch(executor, state, batches, taus)`` replaces
    ``executor.dispatch_trajectory`` (a caller's instrumentation).
    Returns the final state and the session's record: each chunk's rows,
    seconds, overhead and metrics, the controller's plans in order, the
    fitted per-step seconds, the rounds run, the spend, and the builds and
    captures after the warmup."""
    assert superstep >= 1
    dev = resolve_device(device)
    if dispatch is None:
        dispatch = RoundExecutor.dispatch_trajectory
    if controller.current is None:
        controller.initial_plan()

    def build(r0: int, t1s) -> Any:
        """Rounds r0.. at tau1s ``t1s``, stacked ``[k, max(t1s), ...]``
        (zero-padded past each round's tau1)."""
        width = max(t1s)

        def stack(*xs):
            out = np.zeros((len(xs), width) + xs[0].shape[1:], xs[0].dtype)
            for i, x in enumerate(xs):
                out[i, :len(x)] = x
            return out

        return tree_map(stack, *[round_batches(r0 + i, int(t1))
                                 for i, t1 in enumerate(t1s)])

    def upload(host, taus: np.ndarray):
        k, width = len(taus), int(taus[:, 0].max())
        out = tree_map(lambda x: to_device(torch.from_numpy(
            np.ascontiguousarray(x[:k, :width])), dev), host)
        _sync(dev)
        return out

    # set-up (not charged): the executor's warmup on one round at tau1 = 1
    t0 = time.perf_counter()
    one = np.ones((1, 2), np.int32)
    executor.warmup(state, upload(build(0, [1]), one))
    warmup_s = time.perf_counter() - t0
    warm = (executor.compile_count, executor.capture_count)
    warmed = {1}

    prefetch = HostPrefetcher()
    chunks: List[Dict] = []
    r = 0
    try:
        while True:
            taus = controller.next_trajectory(superstep, round_idx=r)
            if taus is None:
                break
            k = len(taus)
            tb0 = time.perf_counter()
            host = None
            if prefetch.pending_meta is not None:
                got, (r0, guess) = prefetch.take()
                if (r0 == r and len(guess) >= k
                        and all(g >= t for g, t in zip(guess, taus[:, 0]))):
                    host = got
                else:
                    prefetch.mark_stale()
            if host is None:
                host = build(r, taus[:, 0])
            batches = upload(host, taus)
            if k not in warmed:
                executor.warmup(state, batches)
                warmed.add(k)
            overhead = time.perf_counter() - tb0
            controller.spend_overhead(overhead)
            nxt = r + k
            guess = [int(taus[:, 0].max())] * superstep
            prefetch.schedule(build, nxt, guess, meta=(nxt, guess))
            t0 = time.perf_counter()
            state, m = dispatch(executor, state, batches, taus)
            _sync(dev)
            seconds = time.perf_counter() - t0
            controller.observe_chunk(taus, seconds)
            chunks.append({
                "round0": r, "taus": taus.tolist(), "seconds": seconds,
                "overhead_s": overhead,
                "loss": m["loss"].tolist(),
                "consensus_sq": m["consensus_sq"].tolist()})
            r = nxt
    finally:
        prefetch.close()
    fitted = controller.fitted_cost_model()
    return state, {
        "chunks": chunks,
        "plans": list(controller.history),
        "rounds": r,
        "fitted": {"t_compute_step": fitted.compute.t_step,
                   "t_gossip_step": fitted.t_gossip_step(None)},
        "fit_rank": controller.fit_rank(),
        "budget_s": controller.budget.wall_clock_s,
        "spent_s": controller.spent_s,
        "exhausted": controller.exhausted,
        "warmup_s": warmup_s,
        "builds_after_warmup": executor.compile_count - warm[0],
        "captures_after_warmup": executor.capture_count - warm[1],
        "prefetch": dict(prefetch.stats),
    }


def cnn_planned_run(flavor: str = "cifar", compression: str = "",
                    gamma: float = 0.6, nodes: int = 10, batch: int = 16,
                    budget_s: float = 2.0, superstep: int = 4, seed: int = 0,
                    device="cuda", dispatch: Optional[Dispatch] = None
                    ) -> Tuple[DFLState, Dict]:
    """The paper's CNN on a ``nodes``-node ring under a wall-clock budget
    of ``budget_s`` seconds, planned over ``DEFAULT_GRID`` from the
    reference's neutral prior and re-planned from measured chunks
    (``run_planned``); ``compression`` is '' (plain DFL) or 'qsgd' (16
    levels, CHOCO step ``gamma``). SGD at the harness's step, 0.05."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    topo = ring(nodes)
    comp = make_compressor(compression, levels=16) if compression else None
    tau1_max = max(t1 for t1, _ in DEFAULT_GRID)
    tau2_max = max(t2 for _, t2 in DEFAULT_GRID)
    cfg = DFLConfig(tau1=tau1_max, tau2=tau2_max, topology=topo,
                    compression=comp, gamma=gamma if comp else 1.0)
    opt = sgd(0.05)

    def loss_fn(params, b):
        return cnn_loss(params, b, flavor)

    params0 = init_cnn(torch.Generator().manual_seed(seed), flavor, dev)
    state = init_state(params0, nodes, opt, compressed=comp is not None,
                       seed=seed)
    executor = RoundExecutor(cfg, loss_fn, opt)
    model_bits = tree_wire_bits(Identity(), params0)
    prior = unit_cost_model(topo, 1.0,
                            rep_dim=max(int(model_bits // 32), 1))
    controller = AdaptiveController(
        Budget(wall_clock_s=budget_s), prior, sigma=1.0, f_gap=1.0,
        compressors=(comp,))
    data = get_data(flavor)
    parts = data.partition(nodes, seed=seed)

    def round_batches(r: int, tau1: int):
        return image_batches_for_dfl(data, parts, tau1, batch, r, seed=seed)

    state, record = run_planned(executor, controller, state, round_batches,
                                superstep=superstep, device=dev,
                                dispatch=dispatch)
    record["config"] = {"flavor": flavor, "compression": compression or "none",
                        "nodes": nodes, "batch": batch, "budget_s": budget_s,
                        "superstep": superstep, "tau_maxima": [tau1_max,
                                                               tau2_max],
                        "model_bits": model_bits, "device": str(dev)}
    return state, record


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--flavor", default="cifar", choices=("mnist", "cifar"))
    p.add_argument("--compression", default="", choices=("", "qsgd"))
    p.add_argument("--gamma", type=float, default=0.6)
    p.add_argument("--nodes", type=int, default=10)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--budget", type=float, default=2.0,
                   help="wall-clock budget of the training loop, seconds")
    p.add_argument("--superstep", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    _, record = cnn_planned_run(
        a.flavor, a.compression, a.gamma, a.nodes, a.batch, a.budget,
        a.superstep, seed=a.seed, device=a.device)
    for ev in record["plans"]:
        print(json.dumps({"plan": ev}))
    for ch in record["chunks"]:
        print(json.dumps({"chunk": ch}))
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ("plans", "chunks")}))
    return record


if __name__ == "__main__":
    main()
