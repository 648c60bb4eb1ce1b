"""The dense executor's rounds as replays of captured step graphs.

Eager PyTorch launches every kernel of a round from Python, and on the
CIFAR CNN that host work outlasts the card's (PERF.md §5). The reference
compiles a superstep into one XLA executable; the port captures the round
step by step into CUDA graphs and replays them, the host keeping only the
loops over K, tau1 and tau2:

  * ``local_first`` / ``local_next``: one local SGD step (``local_phase``'s
    body), the per-node loss copied into, or added to, the round's sum;
  * ``snapshot`` / ``select``: a masked round's start state kept, and its
    masked nodes put back after the local steps (``select_nodes``);
  * ``gossip``: one gossip step, plain (``DenseSubstrate.mix``) or one
    CHOCO-G iteration (``choco_step``);
  * ``tail`` / ``tail_masked``: the loss mean (``loss_over_tau1``, then
    the mean or the masked mean over nodes) and ``consensus_sq``;
  * under ``overlap="pipeline"``: ``stage`` (the exchange's chain loaded
    from the held post-local params), ``fold`` (``z + (g - buf)``, the
    held params advanced) and ``hold`` (a superstep's first round).

Every step reads and writes static buffers (``StepRound``) that a
dispatch fills by device-to-device copies: the state in, one step's batch
before each local step, the round's K1 weight table or confusion matrix,
node masks and ``tau1``, and each gossip step's RNG key (``KeyedDraws``;
a dispatch uploads its ``[K, tau2_max]`` keys once). The set of graphs
does not depend on the schedule, the masks or K, so after ``prepare`` a
dispatch captures nothing and waits for nothing. ``prepare`` warms every
step up once on a side stream (``warm``), then captures each into a
memory pool shared by the graphs of one stream; a replay adds the launches
counted during the capture to ``kernels.ops.LAUNCHES``.

On a CPU state ``capture`` returns the step itself, which runs eagerly
into the same buffers: the CPU path, the same arithmetic as the card's.
On the card a capture that fails raises; nothing runs eagerly there.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.dfl import DFLConfig, DFLState, loss_over_tau1
from repro_torch.core.rng import GeneratorDraws, KeyedDraws
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import to_device
from repro_torch.kernels import ops

__all__ = ["warm", "capture", "StepRound", "GraphedRounds"]


class _Eager:
    """A step run as it is (the CPU path)."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def replay(self, *args) -> None:
        self.fn(*args)


class _Graph:
    """A captured CUDA graph and the kernel launches it makes."""

    def __init__(self, graph, launches: Dict[str, int]):
        self.graph = graph
        self.launches = {k: n for k, n in launches.items() if n}

    def replay(self, *args) -> None:
        self.graph.replay()
        for k, n in self.launches.items():
            ops.LAUNCHES[k] += n


def warm(fn: Callable, device: torch.device) -> None:
    """On CUDA, one call of ``fn`` on a side stream, as a capture needs
    before it (``torch.func`` set-up, cuDNN plans, kernel loads); nothing
    on the CPU."""
    if device.type != "cuda":
        return
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
    main.wait_stream(side)


def capture(fn: Callable, device: torch.device, pool=None):
    """``fn`` (no arguments, or host arguments its graph ignores), warmed
    before (``warm``), as a replayable step on ``device``. On CUDA: one
    call captured into a CUDA graph in ``pool``; the launches counted
    during the capture are taken back out of ``ops.LAUNCHES`` and added at
    each replay. Raises if the capture fails. On the CPU: ``fn`` itself."""
    if device.type != "cuda":
        return _Eager(fn)
    graph = torch.cuda.CUDAGraph()
    before = dict(ops.LAUNCHES)
    try:
        with torch.cuda.graph(graph, pool=pool):
            fn()
        counts = {k: ops.LAUNCHES[k] - before[k] for k in before}
    finally:
        ops.LAUNCHES.update(before)
    return _Graph(graph, counts)


def _assign(dst: Any, src: Any) -> None:
    """Copy ``src``'s leaves into ``dst``'s tensors of the same tree."""
    if dst is None:
        return
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


def _clone(tree: Any) -> Any:
    return tree_map(lambda t: t.detach().clone(), tree)


def _shapes(tree: Any):
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(tree)]


class StepRound:
    """The dynamic dense round (``make_round_fn(..., dynamic_taus=True,
    participation=...)``) as steps over static buffers: ``params``,
    ``opt_state``, ``hat`` (the state), ``batch`` (one step's batch, leaves
    ``[N, ...]``), ``loss_sum`` (the per-node losses summed over the local
    steps) and ``tau1``, ``node_mask`` (bool, f32) with the round-start
    ``params0`` / ``opt0`` under ``masked``, ``operand`` (``mix_operand``'s
    tensors), ``key`` (the seam's key) and ``out`` (``loss``,
    ``consensus_sq``). Under ``pipeline``: ``held`` (z of the round before)
    and ``chain`` (the exchange's params). Each step's results are copied
    into the buffers, so every step reads the same addresses."""

    def __init__(self, cfg: DFLConfig, loss_fn, opt, state: DFLState,
                 batch: Any, *, masked: bool, pipeline: bool):
        if cfg.is_compressed and state.hat_params is None:
            raise ValueError("C-DFL needs init_state(..., compressed=True)")
        self.cfg, self.opt = cfg, opt
        self.device = tree_leaves(state.params)[0].device
        self.sub = DenseSubstrate(cfg.topology)
        self._grad_fn = vmap(grad_and_value(loss_fn))
        self.params = _clone(state.params)
        self.opt_state = _clone(state.opt_state)
        self.hat = _clone(state.hat_params) if cfg.is_compressed else None
        self.batch = _clone(batch)
        with torch.no_grad():   # the loss's shape and dtype
            loss = vmap(loss_fn)(self.params, self.batch)
        self.loss_sum = torch.empty_like(loss)
        self.tau1 = torch.ones((), dtype=loss.dtype, device=self.device)
        self.out = {"loss": torch.empty((), dtype=loss.dtype,
                                        device=self.device),
                    "consensus_sq": torch.empty((), dtype=torch.float32,
                                                device=self.device)}
        dtypes = {t.dtype for t in self.params.values()}
        self.operand = _clone(self.sub.mix_operand(
            self.device, None, dtypes, topology=(
                cfg.topology_schedule[0] if cfg.topology_schedule
                else None)))
        if masked:
            self.params0 = _clone(self.params)
            self.opt0 = _clone(self.opt_state)
            self.node_mask = _clone(self.sub.node_mask_on(
                np.ones(self.sub.num_nodes, np.int32), self.device))
        self.pipeline = pipeline
        if pipeline:
            self.held = _clone(self.params)
            self.chain = _clone(self.params)
        self.key = torch.zeros((), dtype=torch.int64, device=self.device)
        comp = cfg.compression
        self.draws_anything = comp is not None and any(
            comp.draw_shape(t[0].numel()) is not None
            for t in self.params.values())
        self.draws = None       # bind_draws
        self._seam = None

    # -- the state and the seam -------------------------------------------

    def check(self, state: DFLState, batch: Any) -> None:
        """Raise unless ``state`` and one step's ``batch`` have the shapes
        and dtypes the buffers were made for."""
        if tree_leaves(state.params)[0].device != self.device:
            raise ValueError(f"the executor's rounds run on {self.device}; "
                             "dispatch a state on that device")
        for what, got, want in (
                ("state", (state.params, state.opt_state,
                           state.hat_params if self.hat is not None
                           else None),
                 (self.params, self.opt_state, self.hat)),
                ("one step's batch", batch, self.batch)):
            if _shapes(got) != _shapes(want):
                raise ValueError(
                    f"{what} has leaves {_shapes(got)}; the executor's "
                    f"graphs were captured for {_shapes(want)}")

    def bind_draws(self, draws) -> None:
        """The seam the gossip step draws from, for a compressor that
        draws: a counter-based ``draws`` under this round's device key
        (``KeyedDraws``, made once, its counter bases built here on the
        current stream), else ``draws`` itself with the host (round, step),
        which only the CPU path can run (a graph would freeze them)."""
        if not self.draws_anything:
            return
        if isinstance(draws, GeneratorDraws):
            seam = (draws.num_nodes, draws.leaves, draws.device)
            if isinstance(self.draws, KeyedDraws):
                if seam != self._seam:
                    raise ValueError(
                        "the state's seam has other nodes, leaves or device "
                        "than the one the graphs were captured with")
                return
            if self.device.type == "cuda" and self.draws is not None:
                raise ValueError("the executor's graphs were captured "
                                 "without a device key")
            self.draws, self._seam = draws.keyed(self.key), seam
            names = list(self.params)
            self.cfg.compression.draw_many(
                self.draws, 0, 0, names,
                [self.params[k][0].numel() for k in names],
                self.sub.node_ids)
        elif self.device.type == "cuda":
            raise ValueError(
                f"the executor's graphs draw from a device key: the state's "
                f"seam must be a GeneratorDraws on the card, got "
                f"{type(draws).__name__}")
        else:
            self.draws = draws

    def upload_keys(self, draws, round0: int, k: int
                    ) -> Optional[torch.Tensor]:
        """The ``[K, tau2_max]`` keys of rounds ``round0 ..`` on the device,
        in one copy (None for host-keyed draws or a compressor that draws
        nothing)."""
        if not isinstance(self.draws, KeyedDraws):
            return None
        keys = np.array([[draws.step_key(round0 + i, t)
                          for t in range(max(self.cfg.tau2, 1))]
                         for i in range(k)], np.int64)
        return to_device(torch.from_numpy(keys), self.device)

    # -- the steps ----------------------------------------------------------

    def local(self, first: bool) -> None:
        grads, loss = self._grad_fn(self.params, self.batch)
        updates, opt_state = self.opt.update(grads, self.opt_state,
                                             self.params)
        new = {name: (p + updates[name]).to(p.dtype)
               for name, p in self.params.items()}
        _assign(self.params, new)
        _assign(self.opt_state, opt_state)
        if first:
            self.loss_sum.copy_(loss)
        else:
            self.loss_sum.add_(loss)

    def snapshot(self) -> None:
        _assign(self.params0, self.params)
        _assign(self.opt0, self.opt_state)

    def select(self) -> None:
        keep = self.node_mask[0]
        _assign(self.params, self.sub.select_by(keep, self.params,
                                                self.params0))
        _assign(self.opt_state, self.sub.select_by(keep, self.opt_state,
                                                   self.opt0))

    def gossip(self, round_idx: int = 0, step: int = 0) -> None:
        """One gossip step of ``params`` (``chain`` under the pipeline);
        ``round_idx`` / ``step`` reach only a host-keyed seam."""
        x = self.chain if self.pipeline else self.params
        if not self.cfg.is_compressed:
            _assign(x, self.sub.mix_by(x, self.operand))
            return
        x_new, y_new = self.sub.choco_step(
            self.cfg.compression, x, self.hat,
            self.sub.mix_by(self.hat, self.operand), self.cfg.gamma,
            self.draws, round_idx, step)
        _assign(x, x_new)
        _assign(self.hat, y_new)

    def tail(self, masked: bool) -> None:
        per_node = loss_over_tau1(self.loss_sum, self.tau1)
        loss = (self.sub.masked_mean_by(per_node, self.node_mask[1])
                if masked else self.sub.mean_over_nodes(per_node))
        _assign(self.out, {"loss": loss, "consensus_sq":
                           self.sub.consensus_sq(self.params)})

    def stage(self) -> None:
        _assign(self.chain, self.held)

    def fold(self) -> None:
        new = {name: (z + (self.chain[name] - self.held[name])).to(z.dtype)
               for name, z in self.params.items()}
        _assign(self.held, self.params)
        _assign(self.params, new)

    def hold(self) -> None:
        _assign(self.held, self.params)


class GraphedRounds:
    """The rounds of one dense dynamic executor (``RoundExecutor``) as step
    replays. ``prepare(state, batch)`` builds the buffers and captures
    every step a later dispatch can need (the masked ones under
    ``participation``, the exchange's under ``pipeline``); ``run(state,
    batches, rows, k)`` plays ``k`` rounds of the host rows ``[K, 2]`` or
    ``[K, 2 + N + E]``. Under ``pipeline`` on the card the exchange's steps
    replay on a second stream, each in its own memory pool, and events join
    the streams before each fold."""

    def __init__(self, cfg: DFLConfig, loss_fn, opt, *, participation: bool,
                 pipeline: bool):
        self.cfg, self._loss_fn, self._opt = cfg, loss_fn, opt
        self.participation = participation
        self.pipeline = pipeline
        self.steps: Optional[StepRound] = None
        self._replays: Optional[Dict[str, Any]] = None
        self._side: Optional[torch.cuda.Stream] = None  # the exchange's
        self.capture_count = 0
        self._operand_key: Any = ()
        self._mask_key: Any = ()

    @property
    def built(self) -> bool:
        return self.steps is not None

    def prepare(self, state: DFLState, batch: Any) -> None:
        """Buffers shaped after ``state`` and one step's ``batch``, and the
        steps captured; nothing is captured once every step is."""
        if self.steps is None:
            self.steps = StepRound(self.cfg, self._loss_fn, self._opt, state,
                                   batch, masked=self.participation,
                                   pipeline=self.pipeline)
            self._side = (torch.cuda.Stream(self.steps.device)
                          if self.pipeline and self.steps.device.type == "cuda"
                          else None)
        st = self.steps
        st.check(state, batch)
        st.bind_draws(state.draws)
        if self._replays is not None:
            return
        dev = st.device
        main_pool = side_pool = None
        if dev.type == "cuda":
            main_pool = torch.cuda.graph_pool_handle()
            side_pool = (torch.cuda.graph_pool_handle() if self.pipeline
                         else main_pool)
        todo = [("local_first", lambda: st.local(True), main_pool),
                ("local_next", lambda: st.local(False), main_pool),
                ("tail", lambda: st.tail(False), main_pool)]
        if self.participation:
            todo += [("snapshot", st.snapshot, main_pool),
                     ("select", st.select, main_pool),
                     ("tail_masked", lambda: st.tail(True), main_pool)]
        if self.pipeline:
            todo += [("fold", st.fold, main_pool),
                     ("hold", st.hold, main_pool),
                     ("stage", st.stage, side_pool)]
        if self.cfg.tau2 > 0:
            todo.append(("gossip", st.gossip, side_pool))
        # every step warmed before any is captured: a warm call's working
        # set (an LM's local step: tens of GB) then never sits beside the
        # graphs' pool, only one or the other
        for _, fn, _ in todo:
            warm(fn, dev)
        replays = {}
        for name, fn, pool in todo:
            replays[name] = capture(fn, dev, pool)
            self.capture_count += 1
        self._replays = replays

    def buffer_state(self, state: DFLState) -> DFLState:
        """``state`` over the static buffers: a dispatch of it copies
        nothing in or out, and leaves ``state``'s own tensors alone (the
        executor's warmup runs on it)."""
        st = self.steps
        return state._replace(
            params=st.params, opt_state=st.opt_state,
            hat_params=st.hat if st.hat is not None else state.hat_params)

    # -- one dispatch --------------------------------------------------------

    def _side_ctx(self):
        return (torch.cuda.stream(self._side) if self._side is not None
                else contextlib.nullcontext())

    def _join(self, waiter: Optional[torch.cuda.Stream],
              on: Optional[torch.cuda.Stream]) -> None:
        if self._side is not None:
            waiter.wait_stream(on)

    def _set_operand(self, row: np.ndarray, round_idx: int) -> None:
        """The round's gossip operand into the buffer, when it changed."""
        st, cfg, n = self.steps, self.cfg, self.cfg.topology.num_nodes
        if cfg.topology_schedule:
            i = round_idx % len(cfg.topology_schedule)
            key = ("schedule", i)
            get = lambda: st.sub.mix_operand(  # noqa: E731
                st.device, dtypes={t.dtype for t in st.params.values()},
                topology=cfg.topology_schedule[i])
        else:
            mask = st.sub.host_edge_mask(row[2 + n:] if row.shape[0] > 2
                                     else None)
            key = None if mask is None else mask.tobytes()
            get = lambda: st.sub.mix_operand(  # noqa: E731
                st.device, mask, {t.dtype for t in st.params.values()})
        if key != self._operand_key:
            _assign(st.operand, get())
            self._operand_key = key

    def run(self, state: DFLState, batches: Any, rows: np.ndarray, k: int,
            donate: bool) -> Tuple[DFLState, Dict[str, torch.Tensor]]:
        st, rp, n = self.steps, self._replays, self.cfg.topology.num_nodes
        dev = st.device
        main = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        _assign(st.params, state.params)
        _assign(st.opt_state, state.opt_state)
        if st.hat is not None:
            _assign(st.hat, state.hat_params)
        keys = st.upload_keys(state.draws, state.round_idx, k)
        out = {name: torch.empty(k, dtype=t.dtype, device=dev)
               for name, t in st.out.items()}
        leaves = tree_leaves(batches)
        step_bufs = tree_leaves(st.batch)
        r0 = state.round_idx

        def exchange(i: int) -> None:
            """Round ``i``'s gossip steps at its draws and edge mask."""
            self._set_operand(rows[i], r0 + i)
            for t in range(int(rows[i, 1])):
                if keys is not None:
                    st.key.copy_(keys[i, t])
                rp["gossip"].replay(r0 + i, t)

        self._join(self._side, main)
        for i in range(k):
            row = rows[i]
            t1 = int(row[0])
            if self.pipeline and i > 0:
                with self._side_ctx():          # round i-1's exchange
                    rp["stage"].replay()
                    exchange(i - 1)
            masked = (self.participation
                      and not bool(np.asarray(row[2:2 + n]).all()))
            if masked:
                key = row[2:2 + n].tobytes()
                if key != self._mask_key:
                    _assign(st.node_mask, st.sub.node_mask_on(
                        row[2:2 + n], dev))
                    self._mask_key = key
                rp["snapshot"].replay()
            for t in range(t1):
                for buf, leaf in zip(step_bufs, leaves):
                    buf.copy_(leaf[i, t])
                rp["local_first" if t == 0 else "local_next"].replay()
            if masked:
                rp["select"].replay()
            st.tau1.fill_(t1)
            if self.pipeline:
                self._join(main, self._side)
                rp["fold" if i > 0 else "hold"].replay()
            else:
                exchange(i)
            rp["tail_masked" if masked else "tail"].replay()
            for name, v in out.items():
                v[i].copy_(st.out[name])
            if self.pipeline:
                self._join(self._side, main)
        if self.pipeline:                       # the drain
            with self._side_ctx():
                rp["stage"].replay()
                exchange(k - 1)
            self._join(main, self._side)
            rp["fold"].replay()
        if donate:
            _assign(state.params, st.params)
            _assign(state.opt_state, st.opt_state)
            if st.hat is not None:
                _assign(state.hat_params, st.hat)
            new = state
        else:
            new = state._replace(params=_clone(st.params),
                                 opt_state=_clone(st.opt_state),
                                 hat_params=(_clone(st.hat) if st.hat
                                             is not None
                                             else state.hat_params))
        return new._replace(round_idx=r0 + k), out
