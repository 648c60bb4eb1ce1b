"""DFL training CLI for the LM zoo on the port's executor.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --nodes 4 --tau1 4 --tau2 4 --rounds 20 --batch 4 --seq 128 \\
        [--device cuda]

Ported from ``repro.launch.train``, with the reference's flags and its
per-round log lines. As in the reference, the CLI trains the
architecture's ``reduced`` config on the synthetic LM corpus
(``data.lm.SyntheticLM``), every node starting from one set of weights.
``run(args, cfg)`` is the body: it takes any ``ModelConfig``, so a
full-width model runs the same loop (``chip_smoke.py --only lm``).

The hot loop runs on ``core.executor.RoundExecutor``. ``--dispatch fused``
(default) builds one dynamic-(tau1, tau2) round and dispatches
``--superstep`` rounds a call; on the card the rounds replay CUDA graphs
captured in the warmup (``core.graphs``), so a re-plan, a new K, new masks
or a new cohort capture nothing after it. ``--dispatch static`` builds and
captures one round per (tau1, tau2), each warmed before it is dispatched.
Host batches for the next
superstep are built on a worker thread while the device runs
(``HostPrefetcher``). ``--plan-budget`` hands (tau1, tau2) to
``planner.AdaptiveController`` (``--schedule adaptive`` re-plans at
superstep boundaries every ``--replan-every`` rounds, ``trajectory``
dispatches a planned ``[K, 2]`` trajectory each superstep). ``--faults``
runs sporadic rounds of a fault plan, ``--virtual-nodes V [--cohort C]``
the node-batched engine over a sampled cohort, ``--overlap pipeline`` the
one-round-stale exchange. ``--ckpt-dir`` restores the newest intact
checkpoint's parameters and writes one every ``--ckpt-every`` rounds (at
superstep edges) and at the end, in the reference's format.

``--engine sparse`` runs one node per process under
``python -m torch.distributed.run --nproc-per-node N`` (``--nodes N``, a
circulant ``--topology``; ``core.sharded``): each rank takes
``cuda:{LOCAL_RANK % device_count}``, or the CPU with ``--device cpu``;
the group's backend is gloo on the CPU or when ranks share a card, nccl
when each has its own, and the run prints it. Rank 0 prints and writes
the history, telemetry, profile and checkpoint files (a checkpoint
gathers every rank's node). ``--engine auto`` takes the sparse engine
under such a launch when it is eligible and no planner is set, the dense
one otherwise, and ``dense`` always the dense one. The adaptive planner
and the node-batched engine run on the dense engine only, and the dense
and batched engines in one process: a launch of several ranks refuses
them. ``--use-kernels`` is accepted and
changes nothing: a CUDA tensor always takes the kernels
(``launch.steps.kernelize_compressor``). ``--device`` (default cuda) runs
on the CPU when asked, with the kernels' plain versions.

Telemetry, as the reference's: the run writes its events into a
``repro_torch.obs.Telemetry`` sink (the executor's ``compile``,
``superstep`` and ``overlap``, the prefetcher's and the metrics buffer's,
the controller's plans, and ``round``, ``degraded``, ``fault``,
``checkpoint`` and one ``counters`` event a superstep, with the
``kernel_<name>`` launch deltas of ``kernels.ops.LAUNCHES``, replays
counted). ``--telemetry-out F`` writes the stream as JSONL as it runs;
``--history-out F`` writes ``obs.history_view`` of it, the reference's
history JSON; ``--profile-dir D`` runs the loop under ``torch.profiler``
(CPU activity, and CUDA activity on the card) and writes a Chrome trace
into ``D``. ``python -m repro_torch.obs validate|report|trace export``
reads the stream.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_arch, list_archs
from repro_torch.core import (DFLConfig, HostPrefetcher, MetricsBuffer,
                              RoundExecutor, fully_connected, init_state,
                              make_compressor, paper_quasi_ring, ring,
                              round_wire_bits, stack_round_batches)
from repro_torch.core.compression import Identity, tree_wire_bits
from repro_torch.core.dfl import sparse_engine_eligible
from repro_torch.core.rng import GeneratorDraws
from repro_torch.core.sharded import NodeGroup, backend_for, local_rows
from repro_torch.data.lm import (SyntheticLM, lm_batches_for_cohort,
                                 lm_batches_for_dfl)
from repro_torch.device import resolve_device
from repro_torch.faults import CohortSampler, FaultPlan, load_fault_spec
from repro_torch.kernels import ops
from repro_torch.launch.steps import kernelize_compressor
from repro_torch.models import ModelConfig, init_params, train_loss
from repro_torch.obs import Telemetry, history_view
from repro_torch.optim import adamw, momentum_sgd, sgd
from repro_torch.planner import (DEFAULT_GRID, AdaptiveController, Budget,
                                 unit_cost_model)

__all__ = ["make_topology", "make_optimizer", "parse_args", "run", "main"]

Dispatch = Callable[[RoundExecutor, Any, Any, np.ndarray], Any]


def make_topology(name: str, n: int):
    return {
        "ring": lambda: ring(n),
        "full": lambda: fully_connected(n),
        "quasi": lambda: paper_quasi_ring(),
    }[name]()


def make_optimizer(name: str, lr: float):
    return {
        "sgd": lambda: sgd(lr),
        "momentum": lambda: momentum_sgd(lr),
        "adamw": lambda: adamw(lr),
    }[name]()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--tau1", type=int, default=4)
    ap.add_argument("--tau2", type=int, default=4)
    ap.add_argument("--topology", default="ring",
                    choices=["ring", "full", "quasi"])
    ap.add_argument("--compression", default="",
                    choices=["", "top_k", "rand_k", "qsgd", "rand_gossip"])
    ap.add_argument("--gamma", type=float, default=0.6)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "dense", "sparse"],
                    help="sparse: one node per process under "
                         "torch.distributed.run --nproc-per-node N (a "
                         "circulant topology, N == --nodes); auto: sparse "
                         "when so launched and eligible (no --plan-budget), "
                         "else dense; dense: all nodes stacked in one "
                         "process, which a multi-rank launch refuses")
    ap.add_argument("--use-kernels", action="store_true",
                    help="accepted for the reference's command lines: a "
                         "CUDA tensor always takes the kernels")
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adamw"])
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4, help="per node")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--noniid", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--superstep", type=int, default=4,
                    help="rounds a dispatch (K); logging / checkpoint / "
                         "re-plan granularity")
    ap.add_argument("--dispatch", default="fused",
                    choices=["fused", "static"],
                    help="fused: one dynamic-tau round, replayed graphs on "
                         "the card; static: one round built and captured "
                         "per (tau1, tau2)")
    ap.add_argument("--overlap", default="none",
                    choices=["none", "pipeline"],
                    help="'pipeline' folds round k's gossip exchange one "
                         "round late, beside round k+1's local steps")
    ap.add_argument("--plan-budget", type=float, default=0.0,
                    help="wall-clock budget (s); enables the adaptive "
                         "(tau1, tau2) planner")
    ap.add_argument("--replan-every", type=int, default=5,
                    help="rounds between re-plans when --plan-budget is set")
    ap.add_argument("--schedule", default="auto",
                    choices=["auto", "fixed", "adaptive", "trajectory"],
                    help="fixed CLI taus, adaptive boundary re-plans, or "
                         "per-round [K, 2] trajectories (needs "
                         "--plan-budget); auto = adaptive iff --plan-budget")
    ap.add_argument("--virtual-nodes", type=int, default=0,
                    help="simulate this many virtual nodes with the "
                         "node-batched engine, a sampled --cohort a round")
    ap.add_argument("--cohort", type=int, default=0,
                    help="nodes sampled per round under --virtual-nodes "
                         "(default: --nodes)")
    ap.add_argument("--cohort-seed", type=int, default=0,
                    help="seed of the per-round cohort draws")
    ap.add_argument("--faults", default="",
                    help="a JSON fault spec (or @file.json); see "
                         "repro_torch.faults (needs --dispatch fused)")
    ap.add_argument("--faults-seed", type=int, default=None,
                    help="override the fault spec's seed")
    ap.add_argument("--history-out", default="",
                    help="write the history JSON (a view over the "
                         "telemetry stream)")
    ap.add_argument("--telemetry-out", default="",
                    help="write the telemetry event stream (JSONL)")
    ap.add_argument("--profile-dir", default="",
                    help="run under torch.profiler and write a Chrome "
                         "trace into this directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, cfg: Optional[ModelConfig] = None, *,
        generator: Optional[torch.Generator] = None,
        dispatch: Optional[Dispatch] = None,
        log: Callable[[str], None] = print,
        group: Optional[NodeGroup] = None) -> Dict[str, Any]:
    """Train ``cfg`` (default: the ``--arch``'s reduced config) as the CLI
    does. ``generator`` draws the initial weights (default: a CPU generator
    seeded 0); ``dispatch(executor, state, batches, rows)`` replaces
    ``executor.dispatch_trajectory`` (a caller's instrumentation). Returns
    the run's record: the per-round rows (round, tau1, tau2, loss,
    consensus_sq, round_s, ...), the engine and schedule mode, the builds
    and captures at the end of the warmup and at the end, the wire bits,
    the telemetry events and the history view, the final state and the
    executor. ``group``: this rank's ``core.sharded.NodeGroup`` when the
    run is one rank of a node group (``main`` makes it under
    ``torch.distributed.run``); only rank 0 logs and writes files."""
    dev = group.device if group is not None else resolve_device(args.device)
    rank0 = group is None or group.rank == 0
    if not rank0:
        log = _quiet
    if cfg is None:
        cfg = get_arch(args.arch).reduced
    if dispatch is None:
        dispatch = RoundExecutor.dispatch_trajectory
    n = args.nodes
    population = args.virtual_nodes
    sampler = None
    if args.cohort and not population:
        raise SystemExit("--cohort samples a virtual population; set "
                         "--virtual-nodes V")
    if population:
        if args.dispatch != "fused":
            raise SystemExit("--virtual-nodes runs cohort ids as schedule "
                             "data through the dynamic executor (use "
                             "--dispatch fused)")
        if args.engine != "auto":
            raise SystemExit("--virtual-nodes selects the node-batched "
                             "engine; leave --engine auto")
        if args.overlap == "pipeline":
            raise SystemExit("--overlap pipeline double-buffers a fixed "
                             "node set; sampled cohorts change every round "
                             "(use --overlap none)")
        n = args.cohort or args.nodes
        sampler = CohortSampler(population=population, cohort=n,
                                seed=args.cohort_seed)
        log(f"mega-scale: population={population} cohort={n} "
            f"(sampling rate {sampler.rate:.4f})")
    comp = kernelize_compressor(
        make_compressor(args.compression) if args.compression else None,
        args.use_kernels)
    topology = make_topology(args.topology, n)
    opt = make_optimizer(args.optimizer, args.lr)
    eligible = sparse_engine_eligible(
        DFLConfig(tau1=1, tau2=1, topology=topology), group)
    if args.engine == "sparse" and not eligible:
        raise ValueError(
            "sparse engine needs #ranks == --nodes and a circulant topology "
            f"(ranks={group.world if group else 1}, nodes={n}, "
            f"topology={topology.name})")
    if args.engine == "sparse" and args.plan_budget > 0:
        raise ValueError("the adaptive planner runs on the dense engine: "
                         "each rank would plan from its own clock")
    sparse = (eligible and args.engine != "dense" and not population
              and args.plan_budget <= 0)
    if group is not None and group.world > 1 and not sparse:
        raise ValueError(
            f"--engine {args.engine} runs the "
            f"{'batched' if population else 'dense'} engine, every node in "
            f"one process, but this is one of {group.world} ranks: each "
            "would run it whole; launch it as one process"
            + (" (the adaptive planner runs on the dense engine)"
               if args.plan_budget > 0 else ""))

    fault_plan = None
    if args.faults:
        if args.dispatch != "fused":
            raise SystemExit("--faults runs sporadic rounds through the "
                             "participation trajectory path (use --dispatch "
                             "fused)")
        spec = load_fault_spec(args.faults)
        if args.faults_seed is not None:
            spec["seed"] = args.faults_seed
        fault_plan = FaultPlan.from_spec(topology, spec)
        log(f"fault plan: {len(fault_plan.faults)} fault(s), "
            f"seed={fault_plan.seed}")

    tel = Telemetry(path=(args.telemetry_out or None) if rank0 else None,
                    meta=dict(vars(args)))
    corpus = SyntheticLM(vocab_size=cfg.vocab_size,
                         num_nodes=population or n,
                         noniid_alpha=args.noniid, lazy=bool(population))

    def loss_fn(p, b):
        return train_loss(p, b, cfg)

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params0, _ = init_params(cfg, generator, dev)
    shapes = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in params0.items()}
    # the sparse engine holds this rank's node, drawing as the dense
    # engine's seam does for it
    state = init_state(params0, 1 if sparse else population or n, opt,
                       compressed=comp is not None, seed=1,
                       draws=GeneratorDraws(1, population or n,
                                            params0.keys(), dev))
    del params0
    start_round = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        template = (group.gather_rows(state.params) if sparse
                    else state.params)
        restored, start_round = restore_checkpoint(args.ckpt_dir, template)
        if sparse:
            restored = local_rows(restored, group)
        state = state._replace(params=restored)
        log(f"restored round {start_round} from {args.ckpt_dir}")

    schedule_mode = args.schedule
    if schedule_mode == "auto":
        schedule_mode = "adaptive" if args.plan_budget > 0 else "fixed"
    if schedule_mode in ("adaptive", "trajectory") and args.plan_budget <= 0:
        raise SystemExit(f"--schedule {schedule_mode} needs --plan-budget")
    if schedule_mode == "trajectory" and args.dispatch != "fused":
        raise SystemExit("--schedule trajectory dispatches per-round [K, 2] "
                         "schedules through the dynamic executor (use "
                         "--dispatch fused)")
    if args.overlap == "pipeline" and args.dispatch != "fused":
        raise SystemExit("--overlap pipeline rides the dynamic executor "
                         "(use --dispatch fused)")

    controller = None
    tau1, tau2 = args.tau1, args.tau2
    if schedule_mode in ("adaptive", "trajectory"):
        model_bits = tree_wire_bits(Identity(), shapes)
        prior = unit_cost_model(topology, 1.0,
                                rep_dim=max(int(model_bits // 32), 1),
                                overlap=args.overlap)
        controller = AdaptiveController(
            Budget(wall_clock_s=args.plan_budget), prior,
            sigma=1.0, f_gap=1.0, replan_every=args.replan_every,
            compressors=(comp,), telemetry=tel)
        p = controller.initial_plan()
        tau1, tau2 = p.tau1, p.tau2
        log(f"planned tau=({tau1},{tau2}) for budget "
            f"{args.plan_budget:.1f}s (predicted bound "
            f"{p.predicted_bound:.4f})")

    if controller is not None:
        tau1_max = max(max(t1 for t1, _ in DEFAULT_GRID), tau1)
        tau2_max = max(max(t2 for _, t2 in DEFAULT_GRID), tau2)
    else:
        tau1_max, tau2_max = tau1, tau2
    dcfg_max = DFLConfig(tau1=tau1_max, tau2=tau2_max, topology=topology,
                         compression=comp, gamma=args.gamma)
    engine = "batched" if population else "sparse" if sparse else "dense"
    executor = RoundExecutor(
        dcfg_max, loss_fn, opt, engine=engine,
        dynamic=args.dispatch == "fused",
        participation=fault_plan is not None, overlap=args.overlap,
        population=population or None, telemetry=tel,
        group=group if sparse else None)

    wire_cache: Dict[tuple, float] = {}

    def wire_bits_for(t1: int, t2: int) -> float:
        """Deployment wire bits for one (tau1, tau2) round (memoized)."""
        key = (int(t1), int(t2))
        if key not in wire_cache:
            wire_cache[key] = round_wire_bits(
                dataclasses.replace(dcfg_max, tau1=key[0], tau2=key[1]),
                shapes, engine="auto")
        return wire_cache[key]

    bits = wire_bits_for(tau1, tau2)
    log(f"arch={cfg.name} nodes={n} tau=({tau1},{tau2}) "
        f"zeta={topology.zeta:.3f} comp={args.compression or 'none'} "
        f"engine={engine} dispatch={args.dispatch} "
        f"overlap={args.overlap} schedule={schedule_mode} "
        f"superstep={args.superstep} wire={bits/8e6:.1f} MB/round/node "
        f"device={dev}")
    if sparse:
        log(f"sparse engine: {group.world} ranks, one node each, "
            f"backend={group.backend}")

    def round_batch(r: int, t1: int) -> Dict[str, np.ndarray]:
        """One round's host batch tree, leaves ``[t1, N, B, ...]``; a
        sampled cohort's slot j streams global node ``sampler.draw(r)[j]``."""
        if sampler is not None:
            b = dict(lm_batches_for_cohort(corpus, t1, sampler.draw(r),
                                           args.batch, args.seq, r))
        else:
            b = dict(lm_batches_for_dfl(corpus, t1, n, args.batch,
                                        args.seq, r))
        if cfg.has_memory_input:
            m = cfg.memory_tokens or 16
            b["memory"] = np.random.default_rng(1000 + r).standard_normal(
                (t1, n, args.batch, m, cfg.memory_dim or cfg.d_model),
                dtype=np.float32)
        if sparse:      # this rank's node: [t1, 1, B, ...]
            b = {key: v[:, group.rank:group.rank + 1] for key, v in b.items()}
        return b

    def host_rounds(r0: int, t1s) -> List[Dict[str, np.ndarray]]:
        return [round_batch(r0 + i, int(t1)) for i, t1 in enumerate(t1s)]

    def upload(rounds) -> Any:
        """[k, tau1_max, N, B, ...] device batches (rows past a round's
        tau1 zero, never read), copied on the caller's thread."""
        return stack_round_batches(rounds, tau1_max, dev)

    def dummy_batches(k: int):
        zero = {key: np.zeros_like(v) for key, v in round_batch(0, 1).items()}
        return upload([zero] * k)

    end = start_round + args.rounds

    def chunk_len(r: int, rounds_done: int) -> int:
        k = min(max(args.superstep, 1), end - r)
        if schedule_mode == "adaptive":
            k = min(k, args.replan_every - rounds_done % args.replan_every)
        return k

    def remaining_chunk_lens(rr: int, done: int):
        ks = set()
        while rr < end:
            kk = chunk_len(rr, done)
            ks.add(kk)
            rr += kk
            done += kk
        return sorted(ks, reverse=True)

    warmed_shapes = set()

    def warm(ks, t1: int, t2: int) -> None:
        """Build the round and capture its graphs on dummy data for every
        superstep length ahead, so no measured round pays for them."""
        tw0 = time.perf_counter()
        before = executor.compile_count
        for kk in ks:
            if args.dispatch == "fused":
                executor.warmup(state, dummy_batches(kk))
            else:
                executor.warmup(state, dummy_batches(kk), t1, t2)
            warmed_shapes.add(kk)
        if executor.compile_count > before:
            log(f"warmed {executor.compile_count - before} round build(s) "
                f"and {executor.capture_count} step graph(s) in "
                f"{time.perf_counter() - tw0:.1f}s")
        if controller is not None:
            controller.spend_overhead(time.perf_counter() - tw0)

    profiler = None
    if args.profile_dir and rank0:
        from torch.profiler import ProfilerActivity, profile
        profiler = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
        profiler.start()
        log(f"torch profiler trace -> {args.profile_dir}")

    t_warm = time.perf_counter()
    if args.rounds > 0:
        warm(remaining_chunk_lens(start_round, 0), tau1, tau2)
    warmup_s = time.perf_counter() - t_warm
    builds_warm, captures_warm = executor.compile_count, executor.capture_count

    buffer = MetricsBuffer(telemetry=tel)
    prefetch = HostPrefetcher(telemetry=tel, retries=2)
    t0 = time.perf_counter()
    rows_out: List[Dict[str, Any]] = []
    counters = {"rounds_done": 0, "wire": 0.0, "last_ckpt": start_round,
                "last_loss": float("nan")}

    def emit_counters(round0: int, kk: int, launches0: Dict[str, int]
                      ) -> None:
        """A superstep's counters: the kernel launches of its dispatch
        (``ops.LAUNCHES`` deltas, replays counted), the builds and captures
        and the wire and prefetch totals so far (host counters only)."""
        tel.emit("counters", track="dispatch", name="superstep-counters",
                 round0=round0, k=kk, compile_count=executor.compile_count,
                 capture_count=executor.capture_count,
                 wire_bits_total=counters["wire"],
                 prefetch_taken=prefetch.stats["taken"],
                 prefetch_stale=prefetch.stats["stale"],
                 prefetch_cancelled=prefetch.stats["cancelled"],
                 **{f"kernel_{key}": v - launches0.get(key, 0)
                    for key, v in ops.LAUNCHES.items()})

    def do_checkpoint(step: int, extra: dict) -> None:
        ck0 = tel.now()
        params = group.gather_rows(state.params) if sparse else state.params
        if rank0:
            save_checkpoint(args.ckpt_dir, step, params, extra)
        tel.emit("checkpoint", track="checkpoint", name=f"ckpt-{step}",
                 t=ck0, dur=tel.now() - ck0, round=step)

    def flush_rows() -> None:
        rows = buffer.flush()
        for row in rows:
            r = row["round"]
            counters["wire"] += wire_bits_for(row["tau1"], row["tau2"])
            extra: Dict[str, Any] = {}
            if "active_nodes" in row:
                # realized participation rides every round event
                extra = dict(active_nodes=row["active_nodes"],
                             masked_edges=row["masked_edges"],
                             degraded=(row["active_nodes"] < n
                                       or row["masked_edges"] > 0))
            if sampler is not None:
                extra.update(cohort_size=n, population=population)
            tel.emit("round", track="rounds", name=f"round-{r}", round=r,
                     tau1=row["tau1"], tau2=row["tau2"], loss=row["loss"],
                     consensus_sq=row["consensus_sq"],
                     round_s=row["round_s"],
                     wire_bits=wire_bits_for(row["tau1"], row["tau2"]),
                     **extra)
            if extra.get("degraded"):
                tel.emit("degraded", track="faults", name=f"degraded-{r}",
                         round=r, active_nodes=row["active_nodes"],
                         masked_edges=row["masked_edges"])
            if fault_plan is not None:
                for payload in fault_plan.events(r):
                    tel.emit("fault", track="faults",
                             name=f"{payload['kind']}-{payload['phase']}",
                             round=r, **payload)
            if fault_plan is not None and controller is not None:
                nm, em = fault_plan.masks(r)
                controller.observe_participation(nm, em)
            counters["last_loss"] = row["loss"]
            if (r + 1) % args.log_every == 0:
                done = r + 1 - start_round
                log(f"round {r+1:4d} tau=({row['tau1']},{row['tau2']}) "
                    f"loss={row['loss']:.4f} "
                    f"consensus={row['consensus_sq']:.3e} "
                    f"({(time.perf_counter()-t0)/max(done,1):.1f}s/round)")
            if controller is not None and schedule_mode != "trajectory":
                controller.observe(row["tau1"], row["tau2"], row["round_s"])
            rows_out.append(row)
        if rows and controller is not None and schedule_mode == "trajectory":
            controller.observe_chunk(
                [(row["tau1"], row["tau2"]) for row in rows],
                sum(row["round_s"] for row in rows))

    def widen(rows: np.ndarray, r: int) -> np.ndarray:
        """Schedule rows widened by the fault plan's masks and the sampled
        cohorts."""
        if fault_plan is not None:
            rows = fault_plan.mask_trajectory(rows, r)
        if sampler is not None:
            rows = sampler.cohort_trajectory(rows, r,
                                             num_edges=topology.num_edges)
        return rows

    def maybe_checkpoint(r: int) -> None:
        if (args.ckpt_every and args.ckpt_dir
                and r // args.ckpt_every
                > counters["last_ckpt"] // args.ckpt_every):
            do_checkpoint(r, {"loss": counters["last_loss"]})
            counters["last_ckpt"] = r

    try:
        if schedule_mode == "trajectory":
            def tau1_key(r0: int, taus) -> tuple:
                return (r0, tuple(int(t1) for t1, *_rest in taus))

            def schedule_predicted(r0: int, done: int) -> bool:
                if r0 >= end or controller.exhausted:
                    return False
                pred = controller.predict_trajectory(chunk_len(r0, done))
                if pred is None:
                    return False
                prefetch.schedule(host_rounds, r0, pred[:, 0],
                                  meta=tau1_key(r0, pred))
                return True

            r = start_round
            pending = schedule_predicted(r, 0)
            while r < end:
                k = chunk_len(r, counters["rounds_done"])
                taus = controller.next_trajectory(
                    k, round_idx=counters["rounds_done"])
                if taus is None:
                    log(f"budget exhausted after {counters['rounds_done']} "
                        f"rounds ({controller.spent_s:.1f}s)")
                    break
                if len(taus) not in warmed_shapes:
                    tw0 = time.perf_counter()
                    executor.warmup(state, dummy_batches(len(taus)))
                    warmed_shapes.add(len(taus))
                    controller.spend_overhead(time.perf_counter() - tw0)
                tb0 = time.perf_counter()
                host = None
                if pending:
                    got, meta = prefetch.take()
                    if meta == tau1_key(r, taus):
                        host = got
                    else:
                        prefetch.mark_stale()
                if host is None:
                    with tel.span("stale-rebuild" if pending
                                  else "batch-build", track="prefetch"):
                        host = host_rounds(r, taus[:, 0])
                batches = upload(host)
                controller.spend_overhead(time.perf_counter() - tb0)
                t_dispatch = time.perf_counter()
                launches0 = dict(ops.LAUNCHES)
                state, metrics = dispatch(executor, state, batches,
                                          widen(taus, r))
                buffer.push(r, len(taus), None, None, metrics,
                            dispatched_at=t_dispatch)
                r += len(taus)
                counters["rounds_done"] += len(taus)
                flush_rows()
                pending = schedule_predicted(r, counters["rounds_done"])
                emit_counters(r - len(taus), len(taus), launches0)
                maybe_checkpoint(r)

        r = end if schedule_mode == "trajectory" else start_round
        k = chunk_len(r, counters["rounds_done"]) if r < end else 0
        if k > 0:
            prefetch.schedule(host_rounds, r, [tau1] * k, meta=(r, k, tau1))
        while r < end:
            host, meta = prefetch.take()
            if meta != (r, k, tau1):   # stale after a re-plan changed tau1
                prefetch.mark_stale()
                with tel.span("stale-rebuild", track="prefetch"):
                    host = host_rounds(r, [tau1] * k)
            batches = upload(host)
            t_dispatch = time.perf_counter()
            rows = widen(np.tile(np.array([[tau1, tau2]], np.int32), (k, 1)),
                         r)
            launches0 = dict(ops.LAUNCHES)
            state, metrics = dispatch(executor, state, batches, rows)
            buffer.push(r, k, tau1, tau2, metrics, dispatched_at=t_dispatch)
            emit_counters(r, k, launches0)
            r += k
            counters["rounds_done"] += k
            k_next = chunk_len(r, counters["rounds_done"])
            if k_next > 0:
                prefetch.schedule(host_rounds, r, [tau1] * k_next,
                                  meta=(r, k_next, tau1))
            flush_rows()        # one wait a superstep, as the reference
            maybe_checkpoint(r)
            if controller is not None:
                new = controller.maybe_replan(counters["rounds_done"])
                if controller.exhausted:
                    log(f"budget exhausted after {counters['rounds_done']} "
                        f"rounds ({controller.spent_s:.1f}s)")
                    break
                if new is not None:
                    tau1, tau2 = new.tau1, new.tau2
                    log(f"replanned tau=({tau1},{tau2}) at round {r} "
                        f"(t_step={new.round_cost.t_compute_step:.3f}s, "
                        f"t_gossip={new.round_cost.t_gossip_step:.3f}s, "
                        f"predicted bound {new.predicted_bound:.4f}, "
                        f"builds so far: {executor.compile_count})")
                    if args.dispatch == "static" and r < end:
                        warm(remaining_chunk_lens(r, counters["rounds_done"]),
                             tau1, tau2)
            k = chunk_len(r, counters["rounds_done"])
    finally:
        prefetch.close()
        if profiler is not None:
            profiler.stop()
    if args.ckpt_dir:
        do_checkpoint(start_round + counters["rounds_done"], {})
    if profiler is not None:
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "trace.json")
        profiler.export_chrome_trace(path)
        log(f"profile -> {path}")
    # run-level counters: the history view reads schedule_mode and the
    # build counts from here; builds and captures after the warmup must
    # be 0 under --dispatch fused
    tel.emit("counters", track="run", name="run-summary",
             schedule_mode=schedule_mode,
             rounds_done=counters["rounds_done"], engine=engine,
             compile_count_warmup=builds_warm,
             compile_count=executor.compile_count,
             capture_count_warmup=captures_warm,
             capture_count=executor.capture_count,
             wire_bits_total=counters["wire"],
             prefetch_taken=prefetch.stats["taken"],
             prefetch_stale=prefetch.stats["stale"],
             prefetch_cancelled=prefetch.stats["cancelled"],
             wall_s=time.perf_counter() - t0)
    history = history_view(tel.events)
    if args.history_out and rank0:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
        log(f"history -> {args.history_out}")
    if args.telemetry_out:
        log(f"telemetry -> {args.telemetry_out} ({len(tel.events)} events)")
    tel.close()
    log("done")
    return {
        "rows": rows_out, "engine": engine, "schedule_mode": schedule_mode,
        "start_round": start_round, "rounds_done": counters["rounds_done"],
        "warmup_s": warmup_s, "wall_s": time.perf_counter() - t0,
        "builds_after_warmup": executor.compile_count - builds_warm,
        "captures_after_warmup": executor.capture_count - captures_warm,
        "compile_count": executor.compile_count,
        "capture_count": executor.capture_count,
        "wire_bits_total": counters["wire"], "prefetch": dict(prefetch.stats),
        "events": tel.events, "history": history,
        "state": state, "executor": executor,
    }


def _quiet(_msg: str) -> None:
    """The log of a rank other than 0."""


def init_group(args: argparse.Namespace) -> Optional[NodeGroup]:
    """Under ``torch.distributed.run`` (``WORLD_SIZE`` > 1), join the
    default process group and return this rank's ``NodeGroup``: the CPU
    under ``--device cpu``, else ``cuda:{LOCAL_RANK % device_count}``; the
    backend ``core.sharded.backend_for`` picks (nccl when every local rank
    has its own card, else gloo). None outside such a launch."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(
            dev, int(os.environ.get("LOCAL_WORLD_SIZE", "1"))))
    return NodeGroup.current(dev)


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    group = init_group(args)
    try:
        return run(args, group=group)
    finally:
        if group is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
