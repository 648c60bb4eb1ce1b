"""The round executor: K DFL rounds a dispatch, the schedule as data.

Ported from ``repro.core.executor`` for the dense, batched and sparse
engines. The reference compiles one XLA superstep, a ``lax.scan`` over K rounds with (tau1, tau2)
as traced scalars; the port replays CUDA graphs instead, and keeps the
contract:

* **Schedule as data.** ``dispatch_trajectory(state, batches, taus)``
  runs round k of a superstep at ``(taus[k, 0], taus[k, 1])``; batch
  leaves are ``[K, tau1_max, ...]`` and round k reads its first
  ``taus[k, 0]`` steps (so any second dimension of at least the
  superstep's largest tau1 serves: ``launch.planned_run`` copies no
  more). ``dispatch`` is the uniform trajectory. The trajectory is
  validated, and copied to the state's device, once per distinct content
  (memoized); the rounds read their step counts from the host copy, so
  nothing inside a dispatch waits for the device.
* **Graphs** (every mode). In the dynamic mode (plain and C-DFL, with
  and without participation masks, ``overlap="pipeline"`` and the batched
  engine) the round is captured step by step into CUDA graphs
  (``core.graphs``): one local SGD step, one gossip step, the round's
  tail, and the masked and pipelined steps; the host keeps the loops over
  K, tau1 and tau2 and replays them. ``warmup`` (or the first dispatch)
  captures every graph a later dispatch can need, so a re-plan, a new K,
  new masks, new cohorts or a new trajectory capture nothing after it
  (``capture_count``). On the batched engine each round gathers its
  cohort's rows of the ``[V, ...]`` state into the graphs' ``[C, ...]``
  buffers and writes them back, outside the graphs. The static fallback
  captures one whole round per distinct (tau1, tau2) on its first use
  (``core.graphs.StaticRounds``). A dispatch is bitwise ``make_round_fn``'s
  eager rounds on the same device. A capture that fails raises: the card
  never runs these rounds eagerly. On a CPU state the same steps run
  eagerly into the same buffers (the CPU path).
* **Builds.** ``compile_count`` counts builds of the round: 1 in the
  dynamic mode whatever the schedule or K (the step round, or the batched
  engine's round function); the static fallback (``dynamic=False``, which
  ``mixing_impl='dense_power'`` needs) builds one static round per
  distinct (tau1, tau2) and caches it. ``capture_count`` counts the
  captured graphs of the dynamic mode, or the graph sets of the static
  fallback (one a (tau1, tau2)).
* **Donation.** ``donate=True`` (default) keeps the state in place: the
  returned state's leaves are the passed state's tensors, overwritten with
  the result, so every ``data_ptr()`` comes back; ``donate=False`` leaves
  the passed state as it was.
* **Metrics** come back as ``[K]`` tensors on the state's device, beside
  the realized ``tau1`` and ``tau2`` of every round.
* **RNG.** ``round_idx`` advances by K; round k of a superstep draws from
  the state's seam at ``state.round_idx + k``, so a superstep is K
  sequential ``round_fn`` calls. The graphs read each gossip step's key
  from the device (``core.rng.KeyedDraws``): on the card the seam is a
  ``GeneratorDraws``; on the CPU any seam works.
* **Participation** (``participation=True``): rows ``[K, 2 + N + E]``,
  (tau1, tau2), an [N] node mask and an [E] edge mask over
  ``topology.edges()``; ``[K, 2]`` rows are padded with all-ones masks,
  bitwise the unmasked rounds. The masks are read from the host copy of
  the trajectory, so they add no build and no sync. Metrics add
  ``active_nodes`` and ``masked_edges`` per round.
* **Overlap** (``overlap="pipeline"``): round k's local steps and round
  k-1's gossip exchange, folded one round late (``core.dfl.
  pipeline_round_body``), the last exchange drained inside the dispatch;
  on the card the exchange's graphs replay on a second stream beside the
  local steps'. ``make_pipeline_superstep`` is the eager superstep.
* **Sampled cohorts** (``engine="batched", population=V``): rows
  ``[K, 2 + 2C + E]``, (tau1, tau2), the cohort's ``[C]`` global ids, a
  [C] node mask and an [E] edge mask over the cohort topology; ``[K, 2]``
  rows are the identity cohort, all active. Round k gathers its cohort's
  rows of the ``[V, ...]`` state, runs the round and writes them back in
  place.
* **Determinism** (``deterministic=True``, the default): every dispatch
  and capture runs with cuDNN held to deterministic algorithms, so two
  runs give the same bits (``device.deterministic_algorithms``).

``HostPrefetcher`` builds the next superstep's host batches on a worker
thread; the copy to the card stays on the caller's thread
(``stack_round_batches``). ``MetricsBuffer`` keeps dispatched metrics on
the device until a flush, which waits for the device once.

**Telemetry** (``telemetry=``, a ``repro_torch.obs.Telemetry``): the
reference's events. The executor emits ``compile`` on each build of the
round and on each capture of graphs (``count`` the builds, ``captures``
the captures so far), ``superstep`` per dispatch and ``overlap`` per
pipelined dispatch; ``HostPrefetcher`` its ``prefetch`` spans from the
worker thread; ``MetricsBuffer`` a ``flush`` when it waits. Events are
host-side appends around the replays: a dispatch with a sink is bitwise
the same dispatch without one, builds and captures the same, and no event
reads a device tensor (metric values reach events only through a flush).

**The sparse engine** (``engine="sparse", group=...``, one node per
process, ``core.sharded``): every rank runs the same executor over its
``[1, ...]`` state and its ``[K, tau1_max, 1, ...]`` batches with the same
trajectory rows, in every mode above but the batched one (dynamic taus
and re-plans, the static fallback, participation masks,
``overlap="pipeline"``, telemetry). Its rounds run eagerly
(``EagerRounds``), by design and not as a fallback: a gossip step's
exchange under gloo goes through the host, which a CUDA graph cannot
capture. So ``capture_count`` stays 0 there, and ``compile_count`` counts
the round functions built (1 in the dynamic mode, one per distinct
(tau1, tau2) in the static fallback). Rounds on a mesh (the gossip-fsdp
mesh's ``substrate=MeshSubstrate(...)``, the ``NodeMeshSubstrate`` of
gossip-dp and of gossip-fsdp on pods) run the same way, for the same
reason, in every mode but the batched one and ``overlap="pipeline"``
(not ported to the mesh).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dfl import (DFLConfig, DFLState, check_pipeline,
                                  check_sparse, check_taus,
                                  make_pipeline_fns, make_round_fn,
                                  sparse_engine_eligible)
from repro_torch.core.graphs import GraphedRounds, StaticRounds
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import (deterministic_algorithms, resolve_device,
                                to_device)

__all__ = ["RoundExecutor", "EagerRounds", "HostPrefetcher",
           "MetricsBuffer", "make_pipeline_superstep", "stack_round_batches"]


def stack_round_batches(round_batches: Sequence[Any], tau1_max: int,
                        device="cuda") -> Any:
    """K per-round batch trees (leaves ``[tau1, ...]``, numpy arrays or
    tensors) as one superstep tree on ``device`` (leaves
    ``[K, tau1_max, ...]``), zero-padded past each round's tau1; the rounds
    never read the padding."""
    if not round_batches:
        raise ValueError("need at least one round of batches")
    dev = resolve_device(device)

    def one(*leaves):
        xs = [torch.as_tensor(x) for x in leaves]
        for x in xs:
            if x.shape[0] > tau1_max:
                raise ValueError(f"round batch has {x.shape[0]} steps > "
                                 f"tau1_max={tau1_max}")
        out = torch.zeros((len(xs), tau1_max) + tuple(xs[0].shape[1:]),
                          dtype=xs[0].dtype, device=xs[0].device)
        for i, x in enumerate(xs):
            out[i, :x.shape[0]] = x
        return to_device(out, dev)

    return tree_map(one, *round_batches)


def make_pipeline_superstep(pipe_fn, drain_fn, *, participation: bool = False,
                            num_nodes: int = 0, num_edges: int = 0):
    """The eager K-round superstep of ``overlap="pipeline"`` over
    ``core.dfl.make_pipeline_fns``' pair: ``superstep(state, batches,
    taus)`` with host rows ``[K, 2]`` (or ``[K, 2 + N + E]`` under
    ``participation``), batch leaves ``[K, tau1_max, ...]``. Round k folds
    round k-1's exchange; the first round's is not folded (``have`` False,
    ``prev_tau2`` 0) and the last is drained before returning, so the
    state comes back with nothing in flight. Metrics ``[K]``, with the
    realized ``tau1`` / ``tau2`` (and ``active_nodes`` / ``masked_edges``),
    as the executor's. The executor's graphs replay the same steps."""

    def superstep(state: DFLState, batches: Any, taus):
        rows = np.asarray(taus, np.int32)
        n, e = num_nodes, num_edges
        dev = _state_device(state)
        buf, have, prev_tau2 = state.params, False, 0
        prev_edge_mask = np.ones(e, np.int32)
        ms = []
        for i, tau in enumerate(rows):
            b = tree_map(lambda x: x[i], batches)
            if participation:
                state, buf, m = pipe_fn(state, buf, have, prev_tau2,
                                        prev_edge_mask, b, int(tau[0]),
                                        tau[2:2 + n])
                prev_edge_mask = tau[2 + n:]
            else:
                state, buf, m = pipe_fn(state, buf, have, prev_tau2, b,
                                        int(tau[0]))
            have, prev_tau2 = True, int(tau[1])
            ms.append(m)
        state = (drain_fn(state, buf, prev_tau2, prev_edge_mask)
                 if participation else drain_fn(state, buf, prev_tau2))
        metrics = {key: torch.stack([m[key] for m in ms]) for key in ms[0]}
        col = lambda c: to_device(  # noqa: E731
            torch.from_numpy(np.ascontiguousarray(c)), dev)
        metrics.update(tau1=col(rows[:, 0]), tau2=col(rows[:, 1]))
        if participation:
            metrics.update(active_nodes=col(rows[:, 2:2 + n].sum(1)),
                           masked_edges=col(e - rows[:, 2 + n:].sum(1)))
        return state, metrics

    return superstep


def _state_device(state: DFLState) -> torch.device:
    return next(iter(state.params.values())).device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RoundExecutor:
    """Dispatch of DFL rounds and K-round supersteps (dense, batched or
    sparse engine).

    Args:
      cfg: the DFL config; its ``tau1`` / ``tau2`` are the maxima of the
        dynamic mode (every round needs 1 <= tau1 <= cfg.tau1 and
        0 <= tau2 <= cfg.tau2) and bound the static mode's schedules too.
      loss_fn, opt: forwarded to ``core.dfl.make_round_fn``.
      dynamic: True builds one round for every schedule; False is the
        static fallback, one build per distinct (tau1, tau2), cached.
      donate: keep the state in place (the passed state is overwritten
        with the result and returned); with ``donate=False`` the passed
        state is left as it was (the batched engine then copies it first).
      participation: rows ``[K, 2 + N + E]`` with node and edge masks
        (dynamic mode only).
      engine, population: ``"dense"`` (default), or ``"batched"`` with
        ``population=V`` (``"auto"`` picks it when ``population`` is
        given): rows ``[K, 2 + 2C + E]`` of sampled cohorts (dynamic mode
        only), or ``"sparse"`` with ``group`` (below).
      deterministic: hold cuDNN to deterministic algorithms during every
        dispatch and capture (the previous flags are restored after).
      overlap: ``"none"`` (default), or ``"pipeline"``: round k's exchange
        runs beside round k+1's local steps and is folded one round late,
        drained inside each dispatch (dense engine, ``dynamic=True``).
      telemetry: a ``repro_torch.obs.Telemetry`` sink for the dispatch
        events (module docstring), or None.
      group: with ``engine="sparse"`` (or "auto" when
        ``dfl.sparse_engine_eligible``), this rank's
        ``core.sharded.NodeGroup``: the sparse engine's eager rounds
        (``EagerRounds``); misuse raises ``ValueError`` with the
        reference's reasons.
      substrate: a mesh's substrate (dense engine): the gossip-fsdp
        mesh's ``core.substrate.MeshSubstrate`` (every rank dispatches its
        blocks of all N nodes and its part of each node's batches) or
        ``NodeMeshSubstrate`` (gossip-dp, gossip-fsdp on pods: its block
        of its node, its part of the node's batches), as eager rounds
        (``EagerRounds``): a collective over gloo cannot be captured. ``overlap="pipeline"`` with a
        substrate raises (not ported: ROADMAP item 18).
    """

    _TRAJ_CACHE_MAX = 128

    def __init__(self, cfg: DFLConfig, loss_fn, opt, *, engine: str = "dense",
                 dynamic: bool = True, participation: bool = False,
                 donate: bool = True, telemetry=None, overlap: str = "none",
                 population: Optional[int] = None,
                 deterministic: bool = True, group=None, substrate=None):
        if overlap not in ("none", "pipeline"):
            raise ValueError(
                f"unknown overlap mode {overlap!r} (use 'none'|'pipeline')")
        if engine == "auto":
            engine = ("batched" if population is not None else "sparse"
                      if sparse_engine_eligible(cfg, group) else "dense")
        if engine not in ("dense", "batched", "sparse"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "sparse":
            check_sparse(cfg, group)
        if substrate is not None and (engine != "dense"
                                      or population is not None):
            raise ValueError("a given substrate (a mesh's) runs the dense "
                             "engine's eager rounds")
        if substrate is not None and overlap == "pipeline":
            raise ValueError("overlap='pipeline' on a mesh is not ported "
                             "(ROADMAP.md queue 1, item 18; use "
                             "overlap='none')")
        if overlap == "pipeline" and not dynamic:
            raise ValueError(
                "overlap='pipeline' rides the dynamic superstep scan; the "
                "static fallback has no carry to double-buffer "
                "(pass dynamic=True)")
        if overlap == "pipeline" and engine == "batched":
            raise ValueError(
                "overlap='pipeline' is not supported on the batched "
                "engine: consecutive rounds gossip over DIFFERENT sampled "
                "cohorts (use overlap='none')")
        self.batched = engine == "batched"
        if self.batched:
            if population is None:
                raise ValueError("engine='batched' needs population=V (the "
                                 "virtual node count the state is stacked "
                                 "over)")
            participation = True  # cohort rows carry the masks too
        elif population is not None:
            raise ValueError(f"population= is a batched-engine parameter "
                             f"(got engine={engine!r})")
        if participation and not dynamic:
            raise ValueError(
                "participation masks and cohorts are schedule data on the "
                "dynamic path; the static fallback builds per (tau1, tau2) "
                "and cannot express them")
        if dynamic and cfg.mixing_impl == "dense_power":
            raise ValueError(
                "dynamic taus need iterated mixing: dense_power folds C^tau2 "
                "in when the round is built (use dynamic=False)")
        if dynamic and not self.batched:
            if participation and cfg.topology_schedule:
                raise ValueError(
                    "participation masks index cfg.topology.edges(); a "
                    "round-varying topology schedule has no stable edge "
                    "list")
            if overlap == "pipeline":
                check_pipeline(cfg, engine, participation)
        self.cfg = cfg
        self.overlap = overlap
        self.dynamic = dynamic
        self.donate = donate
        self.deterministic = deterministic
        self.participation = participation
        self.population = population
        self.num_nodes = cfg.topology.num_nodes
        self.num_edges = cfg.topology.num_edges
        self._tel = telemetry
        self._in_warmup = False
        self.engine = engine
        eager_kw = (dict(engine="sparse", group=group) if engine == "sparse"
                    else dict(substrate=substrate) if substrate is not None
                    else None)
        self._eager = (EagerRounds(cfg, loss_fn, opt, eager_kw,
                                   dynamic=dynamic,
                                   participation=participation,
                                   pipeline=overlap == "pipeline")
                       if eager_kw is not None else None)
        graphed = dynamic and self._eager is None
        self._graph = (GraphedRounds(cfg, loss_fn, opt,
                                     participation=participation,
                                     pipeline=overlap == "pipeline",
                                     population=population)
                       if graphed else None)
        self._static = (StaticRounds(cfg, loss_fn, opt)
                        if not dynamic and self._eager is None else None)
        self._kind = ("static" if not dynamic else "batched" if self.batched
                      else "pipeline" if overlap == "pipeline" else "dynamic")
        self._traj_cache: Dict[Any, Tuple[np.ndarray, torch.Tensor]] = {}
        self.dispatch_count = 0
        self.rounds_dispatched = 0

    @property
    def tau1_max(self) -> int:
        return self.cfg.tau1

    @property
    def tau2_max(self) -> int:
        return self.cfg.tau2

    @property
    def compile_count(self) -> int:
        """Builds of the round so far: 1 in the dynamic mode after the first
        dispatch or the warmup, whatever the schedules; one per distinct
        (tau1, tau2) in the static fallback."""
        if self._eager is not None:
            return self._eager.build_count
        if self._static is not None:
            return self._static.build_count
        return int(self._graph.built)

    @property
    def capture_count(self) -> int:
        """Graphs captured so far (on a CPU state: steps bound to run
        eagerly). Dynamic mode: the step graphs, fixed once ``warmup`` or
        the first dispatch has run, whatever the schedules, masks, cohorts
        or K. Static fallback: one graph set per distinct (tau1, tau2)."""
        if self._eager is not None:
            return 0
        if self._static is not None:
            return self._static.capture_count
        return self._graph.capture_count

    @property
    def row_width(self) -> int:
        """Trajectory row width: 2; 2 + N + E with participation; 2 + 2C + E
        on the batched engine (tau1, tau2, cohort ids [C], node mask [C],
        edge mask [E])."""
        if self.batched:
            return 2 + 2 * self.num_nodes + self.num_edges
        if self.participation:
            return 2 + self.num_nodes + self.num_edges
        return 2

    def _check_trajectory(self, taus, k: int) -> np.ndarray:
        arr = np.asarray(taus, dtype=np.int32)
        width = self.row_width
        if arr.ndim != 2 or arr.shape[1] not in {2, width}:
            n, e = self.num_nodes, self.num_edges
            layout = (f"(tau1, tau2, cohort ids [{n}], node mask [{n}], edge "
                      f"mask [{e}])" if self.batched else
                      f"(tau1, tau2, node mask [{n}], edge mask [{e}])"
                      if self.participation else "(tau1, tau2)")
            raise ValueError(f"trajectory must be [K, 2] or [K, {width}] "
                             f"{layout} rows, got shape {arr.shape}")
        if width != 2:
            arr = self._widen(arr)
        if arr.shape[0] != k:
            raise ValueError(f"trajectory has {arr.shape[0]} rows but batches "
                             f"carry K={k} rounds")
        for col in (0, 1):
            for v in (int(arr[:, col].min()), int(arr[:, col].max())):
                check_taus(self.cfg, *((v, 0) if col == 0 else (1, v)))
        return arr

    def _widen(self, arr: np.ndarray) -> np.ndarray:
        """[K, 2] rows padded to the full width (the identity cohort, all
        ones), then the cohort ids and the 0/1 masks checked."""
        c, kk = self.num_nodes, arr.shape[0]
        if arr.shape[1] == 2:
            pad = [np.ones((kk, self.row_width - 2), np.int32)]
            if self.batched:
                pad = [np.broadcast_to(np.arange(c, dtype=np.int32), (kk, c)),
                       np.ones((kk, self.row_width - 2 - c), np.int32)]
            arr = np.concatenate([arr] + pad, axis=1)
        masks = arr[:, 2:]
        if self.batched:
            ids, masks = arr[:, 2:2 + c], arr[:, 2 + c:]
            if ids.size and (ids.min() < 0 or ids.max() >= self.population):
                raise ValueError(
                    f"cohort ids must lie in [0, {self.population}) (got "
                    f"range [{ids.min()}, {ids.max()}])")
            if any(len(np.unique(row)) != c for row in ids):
                raise ValueError("cohort ids must be unique within each row "
                                 "(a node cannot occupy two cohort slots)")
        if masks.size and not np.isin(masks, (0, 1)).all():
            raise ValueError("participation masks must be 0/1 (got values "
                             f"{sorted(set(masks.ravel().tolist()))})")
        return arr

    def _prepare(self, key, build: Callable[[], np.ndarray],
                 device: torch.device) -> Tuple[np.ndarray, torch.Tensor]:
        """The validated trajectory and its copy on ``device``, memoized on
        ``key`` (its content) in a bounded FIFO."""
        key = (key, device)
        hit = self._traj_cache.get(key)
        if hit is None:
            arr = build().copy()
            dev = to_device(torch.from_numpy(arr), device)
            if len(self._traj_cache) >= self._TRAJ_CACHE_MAX:
                self._traj_cache.pop(next(iter(self._traj_cache)))
            self._traj_cache[key] = hit = (arr, dev)
        return hit

    def dispatch_trajectory(self, state: DFLState, batches: Any,
                            taus) -> Tuple[DFLState, dict]:
        """One superstep of a heterogeneous schedule: round k runs
        ``(taus[k, 0], taus[k, 1])`` local and gossip steps on the first
        ``taus[k, 0]`` steps of ``batches`` leaves ``[K, tau1_max, ...]``.
        Returns (state', metrics) with metrics ``[K]`` tensors tagged with
        the realized ``tau1`` and ``tau2``. The static fallback plays the
        trajectory as contiguous uniform segments through its cache."""
        k = tree_leaves(batches)[0].shape[0]
        raw = np.asarray(taus, dtype=np.int32)
        arr, dev = self._prepare((k, raw.shape, raw.tobytes()),
                                 lambda: self._check_trajectory(raw, k),
                                 _state_device(state))
        return self._run(state, batches, arr, dev, k)

    def dispatch(self, state: DFLState, batches: Any, tau1: int,
                 tau2: int) -> Tuple[DFLState, dict]:
        """One K-round superstep (K = the batches' leading dim) at a
        uniform (tau1, tau2)."""
        tau1, tau2 = check_taus(self.cfg, tau1, tau2)
        k = tree_leaves(batches)[0].shape[0]
        arr, dev = self._prepare(
            ("uniform", k, tau1, tau2),
            lambda: self._check_trajectory(
                np.tile(np.array([[tau1, tau2]], np.int32), (k, 1)), k),
            _state_device(state))
        return self._run(state, batches, arr, dev, k)

    def dispatch_round(self, state: DFLState, batches: Any, tau1: int,
                       tau2: int) -> Tuple[DFLState, dict]:
        """One round: batch leaves ``[tau1_max, ...]``; per-round metrics."""
        state, metrics = self.dispatch(
            state, tree_map(lambda x: x.unsqueeze(0), batches), tau1, tau2)
        return state, {key: v[0] for key, v in metrics.items()}

    def _run(self, state: DFLState, batches: Any, arr: np.ndarray,
             dev: torch.Tensor, k: int) -> Tuple[DFLState, dict]:
        self.dispatch_count += 1
        self.rounds_dispatched += k
        builds, captures = self.compile_count, self.capture_count
        t0 = self._tel.now() if self._tel is not None else 0.0
        with deterministic_algorithms(self.deterministic):
            out = self._rounds(state, batches, arr, dev, k)
        if self._tel is None:
            return out
        # on the card the dispatch enqueues its replays and returns: dur is
        # the host's time to enqueue them, and the flush event carries the
        # wait for the device
        dur = self._tel.now() - t0
        self._note_builds(builds, captures)
        prefix = "warmup-superstep" if self._in_warmup else "superstep"
        self._tel.emit("superstep", track="dispatch", name=f"{prefix}-k{k}",
                       t=t0, dur=dur, k=k, warmup=self._in_warmup,
                       dispatch=self.dispatch_count)
        if self.overlap == "pipeline" and not self._in_warmup:
            # the exchange of rounds [0, k) is in flight inside this
            # dispatch window (drained before it returns)
            self._tel.emit("overlap", track="overlap",
                           name=f"gossip-inflight-k{k}", t=t0, dur=dur,
                           mode=self.overlap, k=k,
                           dispatch=self.dispatch_count)
        return out

    def _note_builds(self, builds: int, captures: int) -> None:
        """``compile`` events for the builds and captures since the counts
        ``builds`` and ``captures`` were read (host counters, no device
        read)."""
        if self.compile_count > builds:
            self._tel.emit("compile", track="dispatch",
                           name=f"round-build-{self._kind}",
                           count=self.compile_count,
                           captures=self.capture_count)
        if self.capture_count > captures:
            self._tel.emit("compile", track="dispatch",
                           name=f"graph-capture-{self._kind}",
                           count=self.compile_count,
                           captures=self.capture_count,
                           new_captures=self.capture_count - captures)

    def _rounds(self, state: DFLState, batches: Any, arr: np.ndarray,
                dev: torch.Tensor, k: int) -> Tuple[DFLState, dict]:
        if self._eager is not None:
            out, metrics = self._eager.run(state, batches, arr, k,
                                           self.donate)
            return out, self._tag(metrics, arr, dev)
        if self._static is not None:
            self._static.prepare(state, batches)
            out, metrics = self._static.run(state, batches, arr, k,
                                            self.donate)
            return out, self._tag(metrics, arr, dev)
        self._graph.prepare(state, tree_map(lambda b: b[0, 0], batches))
        # the batched rounds write into the state's tensors: keep the
        # caller's state when it is not donated
        if self.batched and not self.donate:
            state = _clone_state(state)
        out, metrics = self._graph.run(state, batches, arr, k, self.donate,
                                       dev)
        return out, self._tag(metrics, arr, dev)

    def _tag(self, metrics: dict, arr: np.ndarray, dev: torch.Tensor) -> dict:
        """The realized schedule (and participation) beside the metrics."""
        c = self.num_nodes
        metrics.update(tau1=dev[:, 0], tau2=dev[:, 1])
        if self.participation:
            # the realized participation, beside the realized schedule
            nodes = dev[:, 2 + c:2 + 2 * c] if self.batched else dev[:, 2:2 + c]
            metrics.update(
                active_nodes=nodes.sum(dim=1, dtype=torch.int32),
                masked_edges=self.num_edges - dev[:, self.row_width
                                                  - self.num_edges:].sum(
                    dim=1, dtype=torch.int32))
        return metrics

    def warmup(self, state: DFLState, batches: Any, tau1: int = 1,
               tau2: int = 0) -> None:
        """Build the round, capture every step graph a later dispatch can
        need (whatever ``tau1`` / ``tau2``) and pay the first-call costs
        (cuDNN plans, ``torch.func`` set-up, kernel loads) at this batch
        shape on a copy of ``state``, then run one dispatch at (tau1, tau2)
        on the copy and wait for the device; the caller's state and the
        dispatch statistics are left as they were. The graphs' copy is
        their own static buffers (``GraphedRounds.buffer_state``), so the
        warmup of a replaying executor holds no second copy of the state
        (an LM tree's is gigabytes). The batched engine's warmup runs on a
        copy of the population. The static fallback captures the graph set
        of (tau1, tau2) here: warm every (tau1, tau2) it will dispatch."""
        n_dispatch, n_rounds = self.dispatch_count, self.rounds_dispatched
        self._in_warmup = True
        span = (self._tel.span("warmup", track="dispatch")
                if self._tel is not None else contextlib.nullcontext())
        try:
            with span:
                builds, captures = self.compile_count, self.capture_count
                with deterministic_algorithms(self.deterministic):
                    if self._eager is not None:
                        dummy = _clone_state(state)
                    elif self._static is not None:
                        self._static.prepare(state, batches)
                        dummy = self._static.buffer_state(state)
                    elif self.batched:
                        dummy = _clone_state(state)
                    else:
                        self._graph.prepare(
                            state, tree_map(lambda b: b[0, 0], batches))
                        dummy = self._graph.buffer_state(state)
                if self._tel is not None:
                    self._note_builds(builds, captures)
                self.dispatch(dummy, batches, tau1, tau2)
                _sync(_state_device(state))
        finally:
            self._in_warmup = False
            self.dispatch_count, self.rounds_dispatched = n_dispatch, n_rounds


class EagerRounds:
    """The rounds of a process group's ranks for ``RoundExecutor``, run
    eagerly on this rank: ``make_round_fn(**engine_kw)`` (the sparse
    engine's ``engine="sparse", group=...``, or a mesh's
    ``substrate=MeshSubstrate(...)`` / ``NodeMeshSubstrate(...)``) built once in the dynamic mode (with
    participation masks), once per distinct (tau1, tau2) in the static
    fallback, or ``make_pipeline_fns``' pair under ``pipeline`` (the
    sparse engine's only). A dispatch
    is K sequential calls of those functions, so it is bitwise the eager
    rounds; nothing is captured (a gloo collective goes through the
    host)."""

    def __init__(self, cfg: DFLConfig, loss_fn, opt, engine_kw: dict, *,
                 dynamic: bool, participation: bool, pipeline: bool):
        self.cfg, self._loss_fn, self._opt = cfg, loss_fn, opt
        self._engine_kw = dict(engine_kw)
        self.dynamic, self.participation = dynamic, participation
        self.pipeline = pipeline
        self._fns: Dict[Any, Any] = {}

    @property
    def build_count(self) -> int:
        return len(self._fns)

    def _fn(self, key):
        if key not in self._fns:
            cfg, loss_fn, opt = self.cfg, self._loss_fn, self._opt
            if key == "pipeline":
                self._fns[key] = make_pipeline_superstep(
                    *make_pipeline_fns(cfg, loss_fn, opt,
                                       participation=self.participation,
                                       **self._engine_kw),
                    participation=self.participation,
                    num_nodes=cfg.topology.num_nodes,
                    num_edges=cfg.topology.num_edges)
            elif key == "dynamic":
                self._fns[key] = make_round_fn(
                    cfg, loss_fn, opt, dynamic_taus=True,
                    participation=self.participation, **self._engine_kw)
            else:
                self._fns[key] = make_round_fn(
                    dataclasses.replace(cfg, tau1=key[0], tau2=key[1]),
                    loss_fn, opt, **self._engine_kw)
        return self._fns[key]

    def run(self, state: DFLState, batches: Any, rows: np.ndarray, k: int,
            donate: bool) -> Tuple[DFLState, Dict[str, torch.Tensor]]:
        r0, n = state.round_idx, self.cfg.topology.num_nodes
        if self.pipeline:
            out, metrics = self._fn("pipeline")(state, batches, rows)
        else:
            out, ms = state, []
            for i in range(k):
                t1, t2 = int(rows[i, 0]), int(rows[i, 1])
                b = tree_map(lambda x: x[i], batches)
                if not self.dynamic:
                    out, m = self._fn((t1, t2))(
                        out, tree_map(lambda x: x[:t1], b))
                elif self.participation:
                    out, m = self._fn("dynamic")(out, b, t1, t2,
                                                 rows[i, 2:2 + n],
                                                 rows[i, 2 + n:])
                else:
                    out, m = self._fn("dynamic")(out, b, t1, t2)
                ms.append(m)
            metrics = {key: torch.stack([m[key] for m in ms])
                       for key in ms[0]}
        if donate:
            for mine, new in ((state.params, out.params),
                              (state.opt_state, out.opt_state),
                              (state.hat_params, out.hat_params)):
                if mine is not None:
                    for d, src in zip(tree_leaves(mine), tree_leaves(new)):
                        if d is not src:
                            d.copy_(src)
            out = state
        return out._replace(round_idx=r0 + k), metrics


def _clone_state(state: DFLState) -> DFLState:
    return state._replace(params=tree_map(torch.clone, state.params),
                          opt_state=tree_map(torch.clone, state.opt_state),
                          hat_params=tree_map(torch.clone, state.hat_params))


class HostPrefetcher:
    """Double-buffered host batch prefetch.

    ``schedule(fn, *args, meta=...)`` starts building the next superstep's
    batches on a daemon thread while the device runs the current one;
    ``take()`` joins and returns ``(result, meta)``. ``meta`` (e.g.
    ``(round0, k, tau1)``) lets the caller see that a re-plan made a
    prefetch stale and rebuild it. Build host arrays on the worker and copy
    them to the card on the caller's thread (``stack_round_batches``), so
    the copy is ordered on the stream the dispatch runs on.

    Double ``schedule`` and ``take`` without a schedule raise
    ``RuntimeError``; a worker's exception is raised again by ``take``.
    ``retries``: a build that raises an ``Exception`` is tried again up to
    ``retries`` times, with a backoff of ``backoff_s`` doubling per attempt.
    ``close()`` stops any backoff, joins the worker and drops its result;
    later schedules raise. ``stats`` counts scheduled, taken, cancelled,
    stale, errors and retries. With a ``telemetry`` sink, each build is a
    ``prefetch`` span emitted from the worker thread, and retries, cancels,
    stale takes and the close are ``prefetch`` events.
    """

    def __init__(self, telemetry=None, retries: int = 0,
                 backoff_s: float = 0.05):
        if retries < 0 or backoff_s < 0.0:
            raise ValueError("retries and backoff_s must be >= 0")
        self._tel = telemetry
        self._pending: Optional[Tuple[threading.Thread, dict, Any]] = None
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        self._stop = threading.Event()
        self.stats: Dict[str, int] = {
            "scheduled": 0, "taken": 0, "cancelled": 0, "stale": 0,
            "errors": 0, "retries": 0}

    def schedule(self, fn: Callable, *args, meta: Any = None) -> None:
        if self._stop.is_set():
            raise RuntimeError("prefetcher closed: no further schedules")
        if self._pending is not None:
            raise RuntimeError(
                "previous prefetch not taken: call take() or cancel() "
                "before scheduling another build")
        self.stats["scheduled"] += 1
        box: dict = {}
        tel = self._tel

        def work():
            t0 = tel.now() if tel is not None else 0.0
            try:
                for attempt in range(self._retries + 1):
                    try:
                        box["out"] = fn(*args)
                        box.pop("err", None)
                        return
                    except BaseException as e:  # raised again by take()
                        box["err"] = e
                        if (attempt >= self._retries
                                or not isinstance(e, Exception)):
                            return
                        self.stats["retries"] += 1
                        if tel is not None:
                            tel.emit("prefetch", track="prefetch",
                                     name="retry", action="retry",
                                     attempt=attempt + 1)
                        if self._stop.wait(self._backoff_s * (2 ** attempt)):
                            return
            finally:
                if tel is not None:
                    tel.emit("prefetch", track="prefetch", name="build",
                             t=t0, dur=tel.now() - t0, action="build",
                             ok="err" not in box)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._pending = (t, box, meta)

    @property
    def pending_meta(self) -> Any:
        return self._pending[2] if self._pending is not None else None

    def take(self) -> Tuple[Any, Any]:
        if self._pending is None:
            raise RuntimeError("nothing scheduled: call schedule() first")
        t, box, meta = self._pending
        self._pending = None
        t.join()
        if "err" in box:
            self.stats["errors"] += 1
            raise box["err"]
        self.stats["taken"] += 1
        return box["out"], meta

    def cancel(self) -> None:
        """Discard a stale prefetch: joins the worker and drops its result
        or its error."""
        if self._pending is None:
            return
        t, _box, _meta = self._pending
        self._pending = None
        t.join()
        self.stats["cancelled"] += 1
        if self._tel is not None:
            self._tel.emit("prefetch", track="prefetch", name="cancel",
                           action="cancel")

    def mark_stale(self) -> None:
        """Count a prefetched chunk the caller rebuilt after a re-plan."""
        self.stats["stale"] += 1
        if self._tel is not None:
            self._tel.emit("prefetch", track="prefetch", name="stale",
                           action="stale")

    def close(self) -> None:
        """Wake any backoff, join the pending worker and drop its result;
        idempotent, and later schedules raise."""
        already = self._stop.is_set()
        self._stop.set()
        if self._pending is not None:
            t, _box, _meta = self._pending
            self._pending = None
            t.join()
            self.stats["cancelled"] += 1
        if self._tel is not None and not already:
            self._tel.emit("prefetch", track="prefetch", name="close",
                           action="close")


class MetricsBuffer:
    """Dispatched round metrics kept on the device until ``flush``.

    ``push`` records a superstep's metrics without waiting; ``flush`` waits
    for the device once, turns them into one host row per round, and
    spreads the wall time since the window opened over its rounds.
    ``dispatched_at``: a ``time.perf_counter()`` taken before the dispatch,
    the window's origin (the clock is monotonic). With a ``telemetry``
    sink, ``flush`` emits a ``flush`` event spanning its wait for the
    device.
    """

    def __init__(self, telemetry=None):
        self._tel = telemetry
        self._pending: List[Tuple[int, int, Optional[int], Optional[int],
                                  dict]] = []
        self._window_start: Optional[float] = None

    def push(self, round0: int, k: int, tau1: Optional[int],
             tau2: Optional[int], metrics: dict,
             dispatched_at: Optional[float] = None) -> None:
        """``tau1`` / ``tau2`` may be None when the metrics carry each
        round's realized ``tau1`` / ``tau2`` (an executor dispatch does);
        the carried values win either way."""
        if self._window_start is None:
            self._window_start = (dispatched_at if dispatched_at is not None
                                  else time.perf_counter())
        self._pending.append((round0, k, tau1, tau2, metrics))

    @property
    def pending_rounds(self) -> int:
        return sum(k for _, k, _, _, _ in self._pending)

    def flush(self) -> List[dict]:
        """Wait once; one row per completed round, in order."""
        if not self._pending:
            return []
        block0 = time.perf_counter()
        for dev in {v.device for *_, m in self._pending for v in m.values()
                    if torch.is_tensor(v)}:
            _sync(dev)
        now = time.perf_counter()
        elapsed = now - (self._window_start or now)
        n = self.pending_rounds
        if self._tel is not None:
            block_s = now - block0
            self._tel.emit("flush", track="metrics", name="metrics-flush",
                           t=self._tel.now() - block_s, dur=block_s,
                           rounds=n, window_s=elapsed)
        per_round_s = elapsed / max(n, 1)
        rows: List[dict] = []
        int_cols = ("active_nodes", "masked_edges")
        for round0, k, tau1, tau2, metrics in self._pending:
            host = {key: np.asarray(v.cpu() if torch.is_tensor(v) else v)
                    for key, v in metrics.items()}
            tau1s = host.pop("tau1", None)
            tau2s = host.pop("tau2", None)
            for i in range(k):
                row = {key: (int(v[i]) if key in int_cols else float(v[i]))
                       for key, v in host.items()}
                row.update(
                    round=round0 + i,
                    tau1=int(tau1s[i]) if tau1s is not None else tau1,
                    tau2=int(tau2s[i]) if tau2s is not None else tau2,
                    round_s=per_round_s)
                rows.append(row)
        self._pending = []
        self._window_start = None
        return rows
