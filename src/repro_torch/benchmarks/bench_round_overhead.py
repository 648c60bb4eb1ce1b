"""Per-round dispatch overhead of the port: rounds one at a time against
K-round supersteps of the ``RoundExecutor``, on the paper's CIFAR CNN.

The port of ``benchmarks/bench_round_overhead.py``'s executor measurements
(its ``--arch`` LM path waits for the port's LM stack). Three strategies
run the same schedule over the same batches, staged on the device before
the clock starts (10 nodes on a ring, the CNN at full width):

  * ``legacy``             one static ``make_round_fn`` per (tau1, tau2),
                           one host sync per round (the loss read back); a
                           re-plan builds a new round function.
  * ``executor_round``     ``RoundExecutor`` with K = 1: one build for every
                           schedule, one sync per round.
  * ``executor_superstep`` K-round supersteps, one sync per superstep.

The schedule re-plans once, half way (default (4, 4) then (2, 1) under
maxima (4, 4)); the executor must make no build after its warmup.
Times are host clock around each dispatch and its sync. On the card,
``syncs_in_dispatch`` also counts the synchronizing CUDA calls inside one
dispatch (``torch.cuda.set_sync_debug_mode``), naming where each is made.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_round_overhead \\
        [--compression top_k] [--rounds 24] [--superstep 6] [--device cuda]

Writes ``results/repro_torch/bench_round_overhead.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import warnings
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.benchmarks.common import save_result
from repro_torch.core import (DFLConfig, RoundExecutor, init_state,
                              make_compressor, make_round_fn, ring,
                              stack_round_batches)
from repro_torch.data.images import image_batches_for_dfl
from repro_torch.device import resolve_device
from repro_torch.launch.cnn_run import get_data
from repro_torch.models.cnn import cnn_loss, init_cnn
from repro_torch.optim import sgd

Schedule = List[Tuple[int, int]]


@dataclasses.dataclass
class Setup:
    """One (model, compressor) configuration on a device: ``cfg(t1, t2)``
    builds its DFLConfig, ``fresh()`` a new state, ``batches[r]`` round r's
    (xs, ys) at tau1 = ``tau1_max`` on the device (round r at a smaller
    tau1 reads the first steps)."""
    cfg: Callable[[int, int], DFLConfig]
    loss_fn: Callable
    opt: object
    fresh: Callable
    batches: List[Tuple[torch.Tensor, torch.Tensor]]
    tau1_max: int
    tau2_max: int
    device: torch.device


def cnn_setup(compression: str = "", rounds: int = 24, tau1_max: int = 4,
              tau2_max: int = 4, flavor: str = "cifar", nodes: int = 10,
              batch: int = 16, frac: float = 0.67, gamma: float = 0.6,
              seed: int = 0, device="cuda") -> Setup:
    """The paper's CNN on a ``nodes``-node ring with ``rounds`` rounds of
    batches from the harness's dataset, all on ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    comp = make_compressor(compression, frac=frac) if compression else None
    opt = sgd(0.05)

    def cfg(t1: int, t2: int) -> DFLConfig:
        return DFLConfig(tau1=t1, tau2=t2, topology=ring(nodes),
                         compression=comp, gamma=gamma if comp else 1.0)

    def loss_fn(params, b):
        return cnn_loss(params, b, flavor)

    params0 = init_cnn(torch.Generator().manual_seed(seed), flavor, dev)

    def fresh():
        return init_state(params0, nodes, opt, compressed=comp is not None,
                          seed=seed)

    data = get_data(flavor)
    parts = data.partition(nodes, seed=seed)
    batches = []
    for r in range(rounds):
        xs, ys = image_batches_for_dfl(data, parts, tau1_max, batch, r,
                                       seed=seed)
        batches.append((torch.from_numpy(xs).to(dev),
                        torch.from_numpy(ys).to(dev)))
    return Setup(cfg, loss_fn, opt, fresh, batches, tau1_max, tau2_max, dev)


def replan_schedule(rounds: int, superstep: int, first=(4, 4),
                    second=(2, 1)) -> Schedule:
    """``first`` until the superstep boundary nearest half way, then
    ``second``."""
    half = min(max(rounds // 2 // superstep * superstep, superstep), rounds)
    return [tuple(first)] * half + [tuple(second)] * (rounds - half)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_legacy(s: Setup, schedule: Schedule) -> Dict:
    """Rounds one at a time through a static round function per (tau1,
    tau2), the loss read back after each; a re-plan builds anew. As in the
    reference, the rounds that built (the first, and the re-plan's) are
    kept apart from the steady mean."""
    state, current, rf = s.fresh(), None, None
    times, built = [], []
    for r, (t1, t2) in enumerate(schedule):
        t0 = time.perf_counter()
        if (t1, t2) != current:
            rf = make_round_fn(s.cfg(t1, t2), s.loss_fn, s.opt)
            current = (t1, t2)
            built.append(r)
        xs, ys = s.batches[r]
        state, m = rf(state, (xs[:t1], ys[:t1]))
        float(m["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    steady = [t for r, t in enumerate(times) if r not in built]
    return {"round_ms": times, "builds": len(built),
            "ms_per_round": sum(steady) / max(len(steady), 1),
            "build_round_ms": [times[r] for r in built]}


def chunks(s: Setup, schedule: Schedule, k: int) -> List[Tuple]:
    """(batches [kk, tau1_max, ...], tau1, tau2, first round) supersteps of
    at most ``k`` rounds of one (tau1, tau2) each, covering ``schedule``."""
    out, r = [], 0
    while r < len(schedule):
        kk = 1
        while (kk < k and r + kk < len(schedule)
               and schedule[r + kk] == schedule[r]):
            kk += 1
        stacked = tuple(
            torch.stack([s.batches[i][j] for i in range(r, r + kk)])
            for j in (0, 1))
        out.append((stacked, *schedule[r], r))
        r += kk
    return out


def run_executor(s: Setup, schedule: Schedule, k: int) -> Dict:
    """The schedule in supersteps of ``k`` rounds through one executor,
    warmed up at every superstep length first; one sync per dispatch."""
    ex = RoundExecutor(s.cfg(s.tau1_max, s.tau2_max), s.loss_fn, s.opt)
    state = s.fresh()
    todo = chunks(s, schedule, k)
    for kk in sorted({c[0][0].shape[0] for c in todo}):
        ex.warmup(state, next(c[0] for c in todo if c[0][0].shape[0] == kk))
    warm_builds = ex.compile_count
    times, rounds = [], 0
    for batches, t1, t2, _ in todo:
        t0 = time.perf_counter()
        state, m = ex.dispatch(state, batches, t1, t2)
        float(m["loss"][-1])
        times.append((time.perf_counter() - t0) * 1e3)
        rounds += batches[0].shape[0]
    return {"dispatch_ms": times, "ms_per_round": sum(times) / rounds,
            "superstep": k, "dispatches": len(times),
            "builds_after_warmup": ex.compile_count - warm_builds}


def syncs_in_dispatch(fn: Callable) -> Tuple[object, List[str]]:
    """``fn()`` with the card's sync debug mode on: its result and where
    each synchronizing CUDA call was made (``file:line: message``)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
                 if "synchroniz" in str(w.message)]


def bench(s: Setup, schedule: Schedule, superstep: int,
          reverse: bool = False) -> Dict:
    """All three strategies over one setup and schedule, in the order
    legacy, one round a dispatch, supersteps (``reverse``: the other way
    round)."""
    runs = [("legacy", lambda: run_legacy(s, schedule)),
            ("executor_round", lambda: run_executor(s, schedule, 1)),
            ("executor_superstep",
             lambda: run_executor(s, schedule, superstep))]
    out = {name: run() for name, run in (runs[::-1] if reverse else runs)}
    if (out["executor_round"]["builds_after_warmup"]
            or out["executor_superstep"]["builds_after_warmup"]):
        raise RuntimeError("the executor built a round function after its "
                           "warmup: a re-plan must not build")
    out["superstep_vs_round"] = (out["executor_round"]["ms_per_round"]
                                 / out["executor_superstep"]["ms_per_round"])
    return out


def device_busy_per_round(s: Setup, k: int) -> Dict:
    """One warmed dispatch of ``k`` rounds at (tau1_max, tau2_max) under
    ``torch.profiler``: the device's busy ms per round (its kernels' self
    time) and the profiled wall ms per round (the profiler slows the
    host, so compare the busy time with an unprofiled round)."""
    from torch.profiler import ProfilerActivity, profile

    ex = RoundExecutor(s.cfg(s.tau1_max, s.tau2_max), s.loss_fn, s.opt)
    state = s.fresh()
    batches = stack_round_batches(s.batches[:k], s.tau1_max, s.device)
    ex.warmup(state, batches, s.tau1_max, s.tau2_max)
    _sync(s.device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, m = ex.dispatch(state, batches, s.tau1_max, s.tau2_max)
        float(m["loss"][-1])
    wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"k": k, "busy_ms_per_round": busy / k,
            "profiled_ms_per_round": wall / k}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compression", default="", choices=("", "top_k"))
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--superstep", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=1,
                    help="runs of the three strategies, every other one in "
                         "reverse order")
    ap.add_argument("--flavor", default="cifar", choices=("mnist", "cifar"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="bench_round_overhead")
    a = ap.parse_args(argv)
    s = cnn_setup(a.compression, a.rounds, flavor=a.flavor, device=a.device)
    schedule = replan_schedule(a.rounds, a.superstep)
    reps = [bench(s, schedule, a.superstep, reverse=bool(i % 2))
            for i in range(a.repeats)]
    modes = ("legacy", "executor_round", "executor_superstep")
    medians = {mode: float(np.median([r[mode]["ms_per_round"] for r in reps]))
               for mode in modes}
    result = {"repeats": reps, "median_ms_per_round": medians}
    state = s.fresh()
    ex = RoundExecutor(s.cfg(s.tau1_max, s.tau2_max), s.loss_fn, s.opt)
    one = stack_round_batches([s.batches[0]], s.tau1_max, s.device)
    ex.warmup(state, one)
    if s.device.type == "cuda":
        _, syncs = syncs_in_dispatch(lambda: ex.dispatch(state, one, 4, 4))
        result["device_busy"] = [device_busy_per_round(s, k)
                                 for k in (1, a.superstep)]
    else:
        syncs = None
    _sync(s.device)
    result.update(config={"compression": a.compression, "rounds": a.rounds,
                          "superstep": a.superstep, "flavor": a.flavor,
                          "schedule": sorted(set(schedule), reverse=True),
                          "device": str(s.device),
                          "device_name": (torch.cuda.get_device_name(s.device)
                                          if s.device.type == "cuda"
                                          else "cpu")},
                  syncs_in_dispatch=syncs)
    print(f"[{a.flavor} {a.compression or 'dfl'}] median ms per round over "
          f"{a.repeats}: legacy {medians['legacy']:.3f} | K=1 "
          f"{medians['executor_round']:.3f} | K={a.superstep} "
          f"{medians['executor_superstep']:.3f} | syncs in a dispatch: "
          f"{'not measured' if syncs is None else len(syncs)}")
    for busy in result.get("device_busy", []):
        print("device busy " + json.dumps(busy))
    print(f"wrote {save_result(a.out, result)}")
    return result


if __name__ == "__main__":
    main()
