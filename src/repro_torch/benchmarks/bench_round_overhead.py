"""Per-round dispatch overhead of the port: rounds one at a time against
K-round supersteps of the ``RoundExecutor``.

The port of ``benchmarks/bench_round_overhead.py``'s executor
measurements. Four measurements (``--measure``):

  * ``cnn`` (default): the paper's CIFAR CNN at full width on a 10-node
    ring; the device's work per round is large, so it shows what the
    executor saves on the main path.
  * ``dispatch``: the reference's acceptance measurement, the 8-node ring
    quadratic model (dimension 64), whose round computes almost nothing,
    so per-round dispatch and host syncs dominate. Schedule (2, 2) then
    (4, 1) half way, supersteps of 10; ``--check`` asserts the
    reference's bar, superstep rounds/s at least 2x legacy.
  * ``telemetry``: the reference's third measurement, the quadratic
    superstep path (dimension 4096, (2, 2), supersteps of 10) with a live
    ``repro_torch.obs.Telemetry`` sink against ``telemetry=None``: one
    executor of each dispatches in turn over the same batches (the order
    flipped every pass), and the overhead is the median of the paired
    time differences over the median time without the sink, with the
    cyclic garbage collector off in the timed loop, as the reference's;
    neither executor may build or capture after its warmup. ``--check``
    holds the throughput loss under 2%.
  * ``reduced_arch``: the reference's LM measurement, an architecture's
    reduced transformer (``--arch``, default Qwen3-1.7B) on an ``--nodes``
    ring (8), ``--batch`` 1 sequence of ``--seq`` 32 tokens a node a step,
    ``sgd(3e-2)``, schedule (``--tau1``, ``--tau2``) = (2, 2) re-planned
    to (``--replan-tau1``, ``--replan-tau2``) = (4, 1) at the superstep
    boundary nearest half way, 20 rounds, supersteps of 10. Device work
    dominates a round here, so the headline is the re-plan: legacy builds
    a new round function, the executor none and captures nothing
    (``zero_recompile_replan``, always asserted; ``--check`` also holds
    it). ``--smoke`` runs the reference's micro transformer (2 layers,
    d_model 32, vocab 64) at 8 tokens.

Three strategies run the same schedule over the same batches, staged on
the device before the clock starts:

  * ``legacy``             one static ``make_round_fn`` per (tau1, tau2),
                           one host sync per round (the loss read back); a
                           re-plan builds a new round function.
  * ``executor_round``     ``RoundExecutor`` with K = 1: one build for every
                           schedule, one sync per round.
  * ``executor_superstep`` K-round supersteps, one sync per superstep.

The schedule re-plans once, half way (CNN: (4, 4) then (2, 1) under maxima
(4, 4)); the executor must make no build and capture no graph after its
warmup (``builds_after_warmup`` counts both). On the card the executor
replays CUDA graphs (``core.graphs``); legacy stays eager, as the
reference's legacy is per-round dispatch.
Times are host clock around each dispatch and its sync. On the card,
``syncs_in_dispatch`` also counts the synchronizing CUDA calls inside one
dispatch (``torch.cuda.set_sync_debug_mode``), naming where each is made.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_round_overhead \\
        [--compression top_k] [--rounds 24] [--superstep 6] [--device cuda]
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_round_overhead \\
        --measure dispatch [--check] [--device cuda]
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_round_overhead \\
        --measure telemetry [--check] [--device cuda]
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_round_overhead \\
        --measure reduced_arch [--smoke] [--check] [--device cuda]

Writes ``results/repro_torch/bench_round_overhead.json`` (``cnn``),
``bench_round_overhead_dispatch.json`` (``dispatch``),
``bench_round_overhead_telemetry.json`` (``telemetry``) or
``bench_round_overhead_reduced_arch.json`` (``reduced_arch``).
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

from repro_torch.benchmarks.common import busy_ms, kernel_events, save_result
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
    batch tuple (the CNN's (xs, ys), the quadratic model's (targets,)) at
    tau1 = ``tau1_max`` on the device (round r at a smaller tau1 reads the
    first steps)."""
    cfg: Callable[[int, int], DFLConfig]
    loss_fn: Callable
    opt: object
    fresh: Callable
    batches: List[Tuple[torch.Tensor, ...]]
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
    kw = {"frac": frac} if compression in ("top_k", "rand_k") else {}
    comp = make_compressor(compression, **kw) if compression else None
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


def quad_setup(rounds: int = 20, tau1_max: int = 4, tau2_max: int = 2,
               nodes: int = 8, dim: int = 64, seed: int = 0,
               device="cuda") -> Setup:
    """The reference's dispatch testbed: ``w`` of ``dim`` per node on a
    ``nodes``-node ring, loss ``mean((w - b)^2)`` on normal targets,
    ``sgd(3e-2)``."""
    dev = resolve_device(device)
    opt = sgd(3e-2)

    def cfg(t1: int, t2: int) -> DFLConfig:
        return DFLConfig(tau1=t1, tau2=t2, topology=ring(nodes))

    def loss_fn(params, b):
        return torch.mean((params["w"] - b[0]) ** 2)

    def fresh():
        return init_state({"w": torch.zeros(dim, device=dev)}, nodes, opt,
                          seed=seed)

    rng = np.random.default_rng(seed)
    batches = [(torch.from_numpy(rng.normal(size=(tau1_max, nodes, dim))
                                 .astype(np.float32)).to(dev),)
               for _ in range(rounds)]
    return Setup(cfg, loss_fn, opt, fresh, batches, tau1_max, tau2_max, dev)


def lm_setup(cfg, rounds: int = 20, tau1_max: int = 4, tau2_max: int = 2,
             nodes: int = 8, batch: int = 1, seq: int = 32, seed: int = 0,
             device="cuda") -> Setup:
    """The reference's ``reduced_arch`` testbed: the LM ``cfg`` on a
    ``nodes``-node ring, ``sgd(3e-2)``, every node from one set of weights
    (a CPU generator seeded ``seed``), ``batch`` random sequences of
    ``seq`` tokens a node a step; a round's batches are (tokens, labels)."""
    from repro_torch.models import init_params, train_loss

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    opt = sgd(3e-2)

    def dfl_cfg(t1: int, t2: int) -> DFLConfig:
        return DFLConfig(tau1=t1, tau2=t2, topology=ring(nodes))

    def loss_fn(params, b):
        return train_loss(params, {"tokens": b[0], "labels": b[1]}, cfg)

    params0, _ = init_params(cfg, torch.Generator().manual_seed(seed), dev)

    def fresh():
        return init_state(params0, nodes, opt, seed=seed)

    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (rounds, tau1_max, nodes, batch, seq + 1),
        dtype=np.int32)
    batches = [(torch.from_numpy(toks[r, ..., :-1].copy()).to(dev),
                torch.from_numpy(toks[r, ..., 1:].copy()).to(dev))
               for r in range(rounds)]
    return Setup(dfl_cfg, loss_fn, opt, fresh, batches, tau1_max, tau2_max,
                 dev)


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
        state, m = rf(state, tuple(b[:t1] for b in s.batches[r]))
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
            for j in range(len(s.batches[r])))
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
    warm_builds = ex.compile_count + ex.capture_count
    times, rounds = [], 0
    for batches, t1, t2, _ in todo:
        t0 = time.perf_counter()
        state, m = ex.dispatch(state, batches, t1, t2)
        float(m["loss"][-1])
        times.append((time.perf_counter() - t0) * 1e3)
        rounds += batches[0].shape[0]
    return {"dispatch_ms": times, "ms_per_round": sum(times) / rounds,
            "superstep": k, "dispatches": len(times),
            "builds_after_warmup": (ex.compile_count + ex.capture_count
                                    - warm_builds)}


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
        raise RuntimeError("the executor built a round function or captured "
                           "a graph after its warmup: a re-plan must do "
                           "neither")
    out["superstep_vs_round"] = (out["executor_round"]["ms_per_round"]
                                 / out["executor_superstep"]["ms_per_round"])
    return out


def device_busy_per_round(s: Setup, k: int) -> Dict:
    """One warmed dispatch of ``k`` rounds at (tau1_max, tau2_max) under
    ``torch.profiler``: the device's busy ms per round (the union of its
    kernels' intervals, ``common.busy_ms``) and the profiled wall ms per
    round (compare the busy time with an unprofiled round)."""
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
    busy = busy_ms(kernel_events(prof))
    return {"k": k, "busy_ms_per_round": busy / k,
            "profiled_ms_per_round": wall / k}


def bench_dispatch(s: Setup, schedule: Schedule, superstep: int,
                   reverse: bool = False) -> Dict:
    """The reference's ``dispatch`` measurement: the three strategies on
    ``s`` in rounds per second, and superstep over legacy."""
    out = bench(s, schedule, superstep, reverse)
    rps = {mode: 1e3 / out[mode]["ms_per_round"]
           for mode in ("legacy", "executor_round", "executor_superstep")}
    out.update(rounds_per_s=rps, speedup_superstep_vs_legacy=(
        rps["executor_superstep"] / rps["legacy"]))
    return out


# passes of the telemetry measurement over its schedule, two dispatch pairs
# each: at the reference's 24, the 2% bar read from -0.99% to +2.07% on an
# H100, at 240 from +0.21% to +0.46%
TELEMETRY_PASSES = 240


def bench_telemetry(s: Setup, superstep: int, rounds: int,
                    passes: int = TELEMETRY_PASSES) -> Dict:
    """The reference's telemetry measurement on ``s``: superstep dispatches
    of a uniform (tau1_max, tau2_max) schedule, an executor with a live
    sink and one without dispatching in turn (the order flipped every
    pass), each dispatch ended by a read of its last loss; the overhead is
    the median paired difference over the median time without the sink.
    Neither executor may build or capture after its warmup."""
    import gc

    from repro_torch.obs import Telemetry

    tel = Telemetry()
    cfg = s.cfg(s.tau1_max, s.tau2_max)
    exes = {"off": RoundExecutor(cfg, s.loss_fn, s.opt),
            "on": RoundExecutor(cfg, s.loss_fn, s.opt, telemetry=tel)}
    states = {mode: s.fresh() for mode in exes}
    todo = chunks(s, [(s.tau1_max, s.tau2_max)] * rounds, superstep)
    for mode, ex in exes.items():
        for kk in sorted({c[0][0].shape[0] for c in todo}):
            ex.warmup(states[mode], next(c[0] for c in todo
                                         if c[0][0].shape[0] == kk))
    warm = {mode: (ex.compile_count, ex.capture_count)
            for mode, ex in exes.items()}
    diffs: List[float] = []
    base: List[float] = []
    ks: List[int] = []
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        for p in range(passes):
            order = ("off", "on") if p % 2 == 0 else ("on", "off")
            for batches, t1, t2, _ in todo:
                ks.append(batches[0].shape[0])
                pair = {}
                for mode in order:
                    t0 = time.perf_counter()
                    states[mode], m = exes[mode].dispatch(states[mode],
                                                          batches, t1, t2)
                    float(m["loss"][-1])
                    pair[mode] = time.perf_counter() - t0
                diffs.append(pair["on"] - pair["off"])
                base.append(pair["off"])
    finally:
        if gc_was_enabled:
            gc.enable()
    for mode, ex in exes.items():
        if (ex.compile_count, ex.capture_count) != warm[mode]:
            raise RuntimeError(f"the telemetry bench built or captured after "
                               f"the warmup (executor {mode!r})")
    k_mean = sum(ks) / len(ks)
    off_s = float(np.median(base))
    diff_s = float(np.median(diffs))
    return {"rounds_per_s_off": k_mean / off_s,
            "rounds_per_s_on": k_mean / (off_s + diff_s),
            "overhead_pct": 100.0 * diff_s / off_s,
            "events_per_run": len(tel.events), "dispatch_pairs": len(diffs),
            "superstep": superstep}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", default="cnn",
                    choices=("cnn", "dispatch", "telemetry", "reduced_arch"))
    ap.add_argument("--compression", default="", choices=("", "top_k"))
    ap.add_argument("--rounds", type=int, default=None,
                    help="cnn: 24; dispatch: 20")
    ap.add_argument("--superstep", type=int, default=None,
                    help="cnn: 6; dispatch: 10")
    ap.add_argument("--repeats", type=int, default=1,
                    help="runs of the three strategies, every other one in "
                         "reverse order")
    ap.add_argument("--flavor", default="cifar", choices=("mnist", "cifar"))
    ap.add_argument("--check", action="store_true",
                    help="dispatch: assert superstep >= 2x legacy rounds/s; "
                         "telemetry: assert the sink costs < 2%%; "
                         "reduced_arch: assert no build or capture on the "
                         "re-plan")
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help="reduced_arch: the architecture")
    ap.add_argument("--nodes", type=int, default=8,
                    help="reduced_arch: ring nodes")
    ap.add_argument("--tau1", type=int, default=2)
    ap.add_argument("--tau2", type=int, default=2)
    ap.add_argument("--replan-tau1", type=int, default=4)
    ap.add_argument("--replan-tau2", type=int, default=1)
    ap.add_argument("--batch", type=int, default=1,
                    help="reduced_arch: sequences a node a step")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced_arch: the micro transformer at 8 tokens "
                         "(the CI config)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if a.measure == "dispatch":
        return main_dispatch(a)
    if a.measure == "telemetry":
        return main_telemetry(a)
    if a.measure == "reduced_arch":
        return main_reduced_arch(a)
    if a.check:
        ap.error("--check applies to --measure dispatch, telemetry and "
                 "reduced_arch")
    a.rounds = 24 if a.rounds is None else a.rounds
    a.superstep = 6 if a.superstep is None else a.superstep
    a.out = a.out or "bench_round_overhead"
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


def main_dispatch(a) -> Dict:
    """``--measure dispatch``: the quadratic testbed, schedule (2, 2) then
    (4, 1) at the superstep boundary nearest half way."""
    rounds = 20 if a.rounds is None else a.rounds
    superstep = 10 if a.superstep is None else a.superstep
    s = quad_setup(rounds, device=a.device)
    schedule = replan_schedule(rounds, superstep, (2, 2), (4, 1))
    reps = [bench_dispatch(s, schedule, superstep, reverse=bool(i % 2))
            for i in range(a.repeats)]
    rps = {mode: float(np.median([r["rounds_per_s"][mode] for r in reps]))
           for mode in reps[0]["rounds_per_s"]}
    speedup = rps["executor_superstep"] / rps["legacy"]
    result = {"repeats": reps, "median_rounds_per_s": rps,
              "speedup_superstep_vs_legacy": speedup,
              "config": {"measure": "dispatch", "nodes": 8, "dim": 64,
                         "rounds": rounds, "superstep": superstep,
                         "schedule": [[2, 2], [4, 1]],
                         "device": str(s.device),
                         "device_name": (torch.cuda.get_device_name(s.device)
                                         if s.device.type == "cuda"
                                         else "cpu")}}
    print(f"[dispatch/quad] legacy {rps['legacy']:.1f} r/s | K=1 "
          f"{rps['executor_round']:.1f} r/s | K={superstep} "
          f"{rps['executor_superstep']:.1f} r/s -> {speedup:.2f}x; no build "
          "after the warmup across the re-plan")
    print(f"wrote {save_result(a.out or 'bench_round_overhead_dispatch', result)}")
    if a.check:
        if speedup < 2.0:
            raise SystemExit(f"check failed: superstep dispatch only "
                             f"{speedup:.2f}x legacy (< 2x bar)")
        print("check OK: superstep >= 2x legacy, no build on re-plan")
    return result


def main_telemetry(a) -> Dict:
    """``--measure telemetry``: the quadratic testbed at dimension 4096,
    (2, 2), supersteps of 10, 20 rounds cycled over ``TELEMETRY_PASSES``
    passes, with and without a sink."""
    rounds = 20 if a.rounds is None else a.rounds
    superstep = 10 if a.superstep is None else a.superstep
    s = quad_setup(rounds, tau1_max=2, tau2_max=2, dim=4096,
                   device=a.device)
    out = bench_telemetry(s, superstep, rounds)
    dev = s.device
    out["config"] = {"measure": "telemetry", "nodes": 8, "dim": 4096,
                     "rounds": rounds, "superstep": superstep,
                     "schedule": [[2, 2]], "device": str(dev),
                     "device_name": (torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else "cpu")}
    print(f"[telemetry/quad] off {out['rounds_per_s_off']:.1f} r/s | on "
          f"{out['rounds_per_s_on']:.1f} r/s -> {out['overhead_pct']:+.2f}% "
          f"overhead ({out['events_per_run']} events, paired over "
          f"{out['dispatch_pairs']} dispatch pairs)")
    print(f"wrote "
          f"{save_result(a.out or 'bench_round_overhead_telemetry', out)}")
    if a.check:
        if out["overhead_pct"] >= 2.0:
            raise SystemExit(f"check failed: telemetry costs "
                             f"{out['overhead_pct']:.2f}% of superstep "
                             "throughput (>= 2% bar)")
        print(f"check OK: telemetry overhead {out['overhead_pct']:+.2f}% < "
              "2%, no build or capture after the warmup")
    return out


def main_reduced_arch(a) -> Dict:
    """``--measure reduced_arch``: the reference's LM measurement across
    the mid-run re-plan, the three strategies over the same batches."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import reduced_from

    rounds = 20 if a.rounds is None else a.rounds
    superstep = 10 if a.superstep is None else a.superstep
    arch = get_arch(a.arch)
    cfg, seq = arch.reduced, a.seq
    if a.smoke:     # the reference's micro transformer
        cfg = reduced_from(arch.model, d_model=32, d_ff=64, num_layers=2,
                           num_heads=2, num_kv_heads=1, head_dim=16,
                           vocab_size=64, attn_q_chunk=8, attn_kv_chunk=8,
                           loss_seq_chunk=8)
        seq = min(seq, 8)
    first, second = (a.tau1, a.tau2), (a.replan_tau1, a.replan_tau2)
    s = lm_setup(cfg, rounds, tau1_max=max(a.tau1, a.replan_tau1),
                 tau2_max=max(a.tau2, a.replan_tau2), nodes=a.nodes,
                 batch=a.batch, seq=seq, device=a.device)
    schedule = replan_schedule(rounds, superstep, first, second)
    out = bench(s, schedule, superstep)     # raises on a build after warmup
    rps = {mode: 1e3 / out[mode]["ms_per_round"]
           for mode in ("legacy", "executor_round", "executor_superstep")}
    replan = schedule.index(second) if second in schedule else None
    result = {"reduced_arch": out, "rounds_per_s": rps,
              "speedup_superstep_vs_legacy": (rps["executor_superstep"]
                                              / rps["legacy"]),
              "zero_recompile_replan": True,
              "config": {"measure": "reduced_arch", "arch": cfg.name,
                         "nodes": a.nodes, "rounds": rounds,
                         "superstep": superstep,
                         "schedule": [list(first), list(second)],
                         "replan_round": replan, "batch": a.batch,
                         "seq": seq, "smoke": a.smoke,
                         "device": str(s.device),
                         "device_name": (torch.cuda.get_device_name(s.device)
                                         if s.device.type == "cuda"
                                         else "cpu")}}
    legacy = out["legacy"]
    print(f"[reduced/{cfg.name}] legacy {rps['legacy']:.2f} r/s ("
          f"{legacy['builds']} builds, re-plan round "
          f"{max(legacy['build_round_ms'][1:], default=0.0):.1f} ms) | K=1 "
          f"{rps['executor_round']:.2f} r/s | K={superstep} "
          f"{rps['executor_superstep']:.2f} r/s; no build or capture after "
          "the warmup across the re-plan")
    print(f"wrote "
          f"{save_result(a.out or 'bench_round_overhead_reduced_arch', result)}")
    if a.check:
        print("check OK: zero builds and captures on the re-plan")
    return result


if __name__ == "__main__":
    main()
