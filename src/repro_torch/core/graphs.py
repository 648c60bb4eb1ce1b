"""The executor's rounds as replays of captured CUDA graphs.

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

On the batched engine (``population=V``) the same steps run over ``[C,
...]`` buffers of one cohort: each round gathers its cohort's rows of the
``[V, ...]`` state into them (``index_select`` by the ids in a device
buffer, copied from the trajectory's device rows) and writes them back
after its tail (``index_copy_``), both outside the graphs, since the
state is the caller's; the seam reads the same id buffer
(``KeyedDraws(ids=)``). The static fallback (``StaticRounds``) captures
one whole static round per distinct (tau1, tau2), and per round of a
topology schedule, on first use.

On a CPU state ``capture`` returns the step itself, which runs eagerly
into the same buffers: the CPU path, the same arithmetic as the card's.
On the card a capture that fails raises; nothing runs eagerly there.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.dfl import (DFLConfig, DFLState, loss_over_tau1,
                                  make_round_fn)
from repro_torch.core.rng import GeneratorDraws, KeyedDraws
from repro_torch.core.substrate import DenseSubstrate
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import to_device
from repro_torch.kernels import ops

__all__ = ["warm", "capture", "StepRound", "GraphedRounds", "StaticRounds"]


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


def _shapes(tree: Any, lead: Optional[int] = None):
    """The leaves' (shape, dtype), the leading dimension replaced by
    ``lead`` when given."""
    return [(((lead,) + tuple(t.shape[1:])) if lead is not None
             else tuple(t.shape), t.dtype) for t in tree_leaves(tree)]


def _load(bufs: Tuple[Any, Any, Any], state: DFLState) -> None:
    """The state's (params, opt_state, hat) copied into the buffers."""
    for buf, tree in zip(bufs, (state.params, state.opt_state,
                                state.hat_params)):
        _assign(buf, tree)


def _result(bufs: Tuple[Any, Any, Any], state: DFLState, donate: bool,
            round_idx: int) -> DFLState:
    """The buffers as the dispatch's state at ``round_idx``: written into
    ``state``'s own tensors under ``donate``, else clones."""
    params, opt_state, hat = bufs
    if donate:
        for tree, buf in zip((state.params, state.opt_state,
                              state.hat_params), bufs):
            if buf is not None:
                _assign(tree, buf)
        new = state
    else:
        new = state._replace(params=_clone(params),
                             opt_state=_clone(opt_state),
                             hat_params=(_clone(hat) if hat is not None
                                         else state.hat_params))
    return new._replace(round_idx=round_idx)


def _over(bufs: Tuple[Any, Any, Any], state: DFLState) -> DFLState:
    """``state`` over the buffers: a dispatch of it copies nothing in or
    out, and leaves ``state``'s own tensors alone (the executor's warmup
    runs on it)."""
    params, opt_state, hat = bufs
    return state._replace(params=params, opt_state=opt_state,
                          hat_params=hat if hat is not None
                          else state.hat_params)


def _check_state(state: DFLState, batch: Any, bufs: Tuple[Any, Any, Any],
                 batch_buf: Any, device: torch.device,
                 population: Optional[int] = None) -> None:
    """Raise unless ``state`` (its leaves leading with ``population`` when
    given) and ``batch`` have the shapes and dtypes of the buffers."""
    if tree_leaves(state.params)[0].device != device:
        raise ValueError(f"the executor's rounds run on {device}; dispatch a "
                         "state on that device")
    got = (state.params, state.opt_state,
           state.hat_params if bufs[2] is not None else None)
    for what, have, want, lead in (
            ("state", got, bufs, population),
            ("one step's batch", batch, batch_buf, None)):
        if _shapes(have) != _shapes(want, lead):
            raise ValueError(
                f"{what} has leaves {_shapes(have)}; the executor's graphs "
                f"were captured for {_shapes(want, lead)}")


def _bind_keyed(draws, key: torch.Tensor, device: torch.device,
                current, seam, ids: Optional[torch.Tensor] = None):
    """The seam a captured round draws from, and its identity: ``draws``
    under the device ``key`` (and ``ids``) when it is a ``GeneratorDraws``
    (made once; a later state must bring the same seam), else ``draws``
    itself, which only the CPU path can run (a graph would freeze the host
    (round, step))."""
    if isinstance(draws, GeneratorDraws):
        new_seam = (draws.num_nodes, draws.leaves, draws.device)
        if isinstance(current, KeyedDraws):
            if new_seam != seam:
                raise ValueError(
                    "the state's seam has other nodes, leaves or device "
                    "than the one the graphs were captured with")
            return current, seam
        if device.type == "cuda" and current is not None:
            raise ValueError("the executor's graphs were captured without a "
                             "device key")
        return draws.keyed(key, ids), new_seam
    if device.type == "cuda":
        raise ValueError(
            f"the executor's graphs draw from a device key: the state's seam "
            f"must be a GeneratorDraws on the card, got "
            f"{type(draws).__name__}")
    return draws, seam


def _upload_keys(draws, keyed, round0: int, k: int, steps: int,
                 device: torch.device) -> Optional[torch.Tensor]:
    """The ``[K, steps]`` keys of rounds ``round0 ..`` on ``device`` in one
    copy (None unless the rounds draw from a ``KeyedDraws``)."""
    if not isinstance(keyed, KeyedDraws):
        return None
    keys = np.array([[draws.step_key(round0 + i, t) for t in range(steps)]
                     for i in range(k)], np.int64)
    return to_device(torch.from_numpy(keys), device)


class StepRound:
    """The dynamic dense round (``make_round_fn(..., dynamic_taus=True,
    participation=...)``) as steps over static buffers: ``params``,
    ``opt_state``, ``hat`` (the state), ``batch`` (one step's batch, leaves
    ``[N, ...]``), ``loss_sum`` (the per-node losses summed over the local
    steps) and ``tau1``, ``node_mask`` (bool, f32) with the round-start
    ``params0`` / ``opt0`` under ``masked``, ``operand`` (``mix_operand``'s
    tensors), ``key`` (the seam's key) and ``out`` (``loss``,
    ``consensus_sq``). Under ``pipeline``: ``held`` (z of the round before)
    and ``chain`` (the exchange's params). Under ``cohort`` (the batched
    engine): ``ids``, the round's ``[C]`` global node ids, which the seam
    draws for. Each step's results are copied into the buffers, so every
    step reads the same addresses."""

    def __init__(self, cfg: DFLConfig, loss_fn, opt, state: DFLState,
                 batch: Any, *, masked: bool, pipeline: bool,
                 cohort: bool = False):
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
        self.ids = (torch.arange(self.sub.num_nodes, dtype=torch.int64,
                                 device=self.device) if cohort else None)
        comp = cfg.compression
        self.draws_anything = comp is not None and any(
            comp.draw_shape(t[0].numel()) is not None
            for t in self.params.values())
        self.draws = None       # bind_draws
        self._seam = None

    # -- the state and the seam -------------------------------------------

    def check(self, state: DFLState, batch: Any,
              population: Optional[int] = None) -> None:
        """Raise unless ``state`` (leaves leading with ``population`` on
        the batched engine) and one step's ``batch`` have the shapes and
        dtypes the buffers were made for."""
        _check_state(state, batch, (self.params, self.opt_state, self.hat),
                     self.batch, self.device, population)

    def bind_draws(self, draws) -> None:
        """The seam the gossip step draws from, for a compressor that
        draws: a counter-based ``draws`` under this round's device key (and
        the cohort's device ids) (``KeyedDraws``, made once, its counter
        bases built here on the current stream), else ``draws`` itself with
        the host (round, step), which only the CPU path can run."""
        if not self.draws_anything:
            return
        fresh = not isinstance(self.draws, KeyedDraws)
        self.draws, self._seam = _bind_keyed(draws, self.key, self.device,
                                             self.draws, self._seam, self.ids)
        if fresh and isinstance(self.draws, KeyedDraws):
            names = list(self.params)
            self.cfg.compression.draw_many(
                self.draws, 0, 0, names,
                [self.params[k][0].numel() for k in names],
                self.sub.node_ids)

    def upload_keys(self, draws, round0: int, k: int
                    ) -> Optional[torch.Tensor]:
        """The ``[K, tau2_max]`` keys of rounds ``round0 ..`` on the device,
        in one copy (None for host-keyed draws or a compressor that draws
        nothing)."""
        return _upload_keys(draws, self.draws, round0, k,
                            max(self.cfg.tau2, 1), self.device)

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
    """The rounds of one dynamic executor (``RoundExecutor``) as step
    replays. ``prepare(state, batch)`` builds the buffers and captures
    every step a later dispatch can need (the masked ones under
    ``participation``, the exchange's under ``pipeline``); ``run(state,
    batches, rows, k)`` plays ``k`` rounds of the host rows ``[K, 2]``,
    ``[K, 2 + N + E]`` or, under ``population`` (the batched engine),
    ``[K, 2 + 2C + E]``. Under ``pipeline`` on the card the exchange's steps
    replay on a second stream, each in its own memory pool, and events join
    the streams before each fold."""

    def __init__(self, cfg: DFLConfig, loss_fn, opt, *, participation: bool,
                 pipeline: bool, population: Optional[int] = None):
        self.cfg, self._loss_fn, self._opt = cfg, loss_fn, opt
        self.population = population
        self.participation = participation or population is not None
        self.pipeline = pipeline
        n = cfg.topology.num_nodes
        # where a row's node mask and edge mask start
        self._node_at = 2 + n if population is not None else 2
        self._edge_at = self._node_at + n
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
        """Buffers shaped after ``state`` (its first C rows on the batched
        engine) and one step's ``batch``, and the steps captured; nothing
        is captured once every step is."""
        if self.steps is None:
            view = state
            if self.population is not None:
                c = self.cfg.topology.num_nodes
                view = state._replace(
                    params=tree_map(lambda x: x[:c], state.params),
                    opt_state=tree_map(lambda x: x[:c], state.opt_state),
                    hat_params=(None if state.hat_params is None else
                                tree_map(lambda x: x[:c], state.hat_params)))
            self.steps = StepRound(self.cfg, self._loss_fn, self._opt, view,
                                   batch, masked=self.participation,
                                   pipeline=self.pipeline,
                                   cohort=self.population is not None)
            self._side = (torch.cuda.Stream(self.steps.device)
                          if self.pipeline and self.steps.device.type == "cuda"
                          else None)
        st = self.steps
        st.check(state, batch, self.population)
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
        """``state`` over the static buffers (``_over``; not on the batched
        engine, whose state is the population)."""
        st = self.steps
        return _over((st.params, st.opt_state, st.hat), state)

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
        st, cfg = self.steps, self.cfg
        if cfg.topology_schedule:
            i = round_idx % len(cfg.topology_schedule)
            key = ("schedule", i)
            get = lambda: st.sub.mix_operand(  # noqa: E731
                st.device, dtypes={t.dtype for t in st.params.values()},
                topology=cfg.topology_schedule[i])
        else:
            mask = st.sub.host_edge_mask(row[self._edge_at:]
                                         if row.shape[0] > 2 else None)
            key = None if mask is None else mask.tobytes()
            get = lambda: st.sub.mix_operand(  # noqa: E731
                st.device, mask, {t.dtype for t in st.params.values()})
        if key != self._operand_key:
            _assign(st.operand, get())
            self._operand_key = key

    def run(self, state: DFLState, batches: Any, rows: np.ndarray, k: int,
            donate: bool, dev_rows: Optional[torch.Tensor] = None
            ) -> Tuple[DFLState, Dict[str, torch.Tensor]]:
        """``k`` rounds of ``rows`` from ``state``. On the batched engine
        ``dev_rows`` is the rows' copy on the device (the cohort ids are
        read from it) and the rounds write the cohorts' rows of ``state``
        in place, whatever ``donate``."""
        st, rp, n = self.steps, self._replays, self.cfg.topology.num_nodes
        dev = st.device
        batched = self.population is not None
        main = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        bufs = (st.params, st.opt_state, st.hat)
        if batched:
            full = tree_leaves((state.params, state.opt_state,
                                state.hat_params if st.hat is not None
                                else None))
        else:
            _load(bufs, state)
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
            if batched:                 # the cohort's rows in
                st.ids.copy_(dev_rows[i, 2:2 + n])
                if not isinstance(st.draws, KeyedDraws):
                    # a host seam (the CPU path) draws by the host ids
                    st.sub.node_ids = row[2:2 + n].astype(np.int64)
                for buf, f in zip(tree_leaves(bufs), full):
                    torch.index_select(f, 0, st.ids, out=buf)
            if self.pipeline and i > 0:
                with self._side_ctx():          # round i-1's exchange
                    rp["stage"].replay()
                    exchange(i - 1)
            node_mask = row[self._node_at:self._node_at + n]
            masked = (self.participation
                      and not bool(np.asarray(node_mask).all()))
            if masked:
                key = node_mask.tobytes()
                if key != self._mask_key:
                    _assign(st.node_mask, st.sub.node_mask_on(node_mask, dev))
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
            if batched:                 # and back, in place
                for buf, f in zip(tree_leaves(bufs), full):
                    f.index_copy_(0, st.ids, buf)
            if self.pipeline:
                self._join(self._side, main)
        if self.pipeline:                       # the drain
            with self._side_ctx():
                rp["stage"].replay()
                exchange(k - 1)
            self._join(main, self._side)
            rp["fold"].replay()
        if batched:             # the cohorts' rows are written already
            return state._replace(round_idx=r0 + k), out
        return _result(bufs, state, donate, r0 + k), out


class StaticRounds:
    """The static fallback's rounds (``RoundExecutor(dynamic=False)``, which
    ``mixing_impl="dense_power"`` needs) as replays: one graph set per
    distinct (tau1, tau2), built and captured on first use, each graph one
    whole static round (``make_round_fn`` at that (tau1, tau2)) over static
    buffers, one graph per round of a topology schedule. A dispatch copies
    the state in, each round's batch and gossip keys (a ``[tau2]`` key
    vector, ``KeyedDraws``) into their buffers, and the state out at its
    end; a key seen before captures nothing, and a dispatch is bitwise the
    eager static rounds. On a CPU state the rounds run eagerly over the
    same buffers with the host round index (the CPU path)."""

    def __init__(self, cfg: DFLConfig, loss_fn, opt):
        self.cfg, self._loss_fn, self._opt = cfg, loss_fn, opt
        self._fns: Dict[Tuple[int, int], Callable] = {}
        self._sets: Dict[Tuple[int, int], list] = {}
        self._pool = None
        self.device: Optional[torch.device] = None
        self.params = self.opt_state = self.hat = self.batch = None
        self.out: Dict[str, torch.Tensor] = {}
        self.keys: Optional[torch.Tensor] = None
        self.draws = None
        self._seam = None
        self.draws_anything = False

    @property
    def build_count(self) -> int:
        return len(self._fns)

    @property
    def capture_count(self) -> int:
        """Graph sets captured (on a CPU state: sets bound to run
        eagerly)."""
        return len(self._sets)

    def prepare(self, state: DFLState, batches: Any) -> None:
        """The buffers, shaped after ``state`` and one round of
        ``batches`` (leaves ``[K, T, N, ...]``) at ``cfg.tau1`` steps, and
        the seam bound."""
        if self.params is None:
            cfg = self.cfg
            if cfg.is_compressed and state.hat_params is None:
                raise ValueError("C-DFL needs init_state(..., "
                                 "compressed=True)")
            self.device = tree_leaves(state.params)[0].device
            self.params = _clone(state.params)
            self.opt_state = _clone(state.opt_state)
            self.hat = _clone(state.hat_params) if cfg.is_compressed else None
            self.batch = tree_map(lambda b: torch.zeros(
                (cfg.tau1,) + tuple(b.shape[2:]), dtype=b.dtype,
                device=b.device), batches)
            with torch.no_grad():   # the loss's shape and dtype
                loss = vmap(self._loss_fn)(self.params, tree_map(
                    lambda b: b[0], self.batch))
            self.out = {"loss": torch.empty((), dtype=loss.dtype,
                                            device=self.device),
                        "consensus_sq": torch.empty((), dtype=torch.float32,
                                                    device=self.device)}
            self.keys = torch.zeros(max(cfg.tau2, 1), dtype=torch.int64,
                                    device=self.device)
            comp = cfg.compression
            self.draws_anything = comp is not None and any(
                comp.draw_shape(t[0].numel()) is not None
                for t in self.params.values())
            if self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
        _check_state(state, tree_map(lambda b: b[0, 0], batches),
                     (self.params, self.opt_state, self.hat),
                     tree_map(lambda b: b[0], self.batch), self.device)
        if self.draws_anything:
            self.draws, self._seam = _bind_keyed(
                state.draws, self.keys, self.device, self.draws, self._seam)
        else:
            self.draws = state.draws

    def _round(self, key: Tuple[int, int], round_idx: int) -> None:
        t1 = key[0]
        st = DFLState(self.params, self.opt_state, self.hat, round_idx,
                      self.draws)
        new, m = self._fns[key](st, tree_map(lambda b: b[:t1], self.batch))
        _assign(self.params, new.params)
        _assign(self.opt_state, new.opt_state)
        _assign(self.hat, new.hat_params)
        _assign(self.out, m)

    def ensure(self, key: Tuple[int, int]) -> None:
        """Build and capture the graph set of ``key`` unless it exists.
        Call before the state is copied in (a warm call runs the round on
        the buffers)."""
        if key in self._sets:
            return
        if key not in self._fns:
            self._fns[key] = make_round_fn(
                dataclasses.replace(self.cfg, tau1=key[0], tau2=key[1]),
                self._loss_fn, self._opt)
        phases = max(len(self.cfg.topology_schedule), 1)
        # a graph replays the round of its schedule phase; the CPU path
        # passes the host round index (a host seam draws by it)
        fns = [lambda r=p: self._round(key, r) for p in range(phases)]
        for fn in fns:
            warm(fn, self.device)
        self._sets[key] = [capture(fn, self.device, self._pool) for fn in fns]

    def buffer_state(self, state: DFLState) -> DFLState:
        """``state`` over the static buffers (``_over``)."""
        return _over((self.params, self.opt_state, self.hat), state)

    def run(self, state: DFLState, batches: Any, rows: np.ndarray, k: int,
            donate: bool) -> Tuple[DFLState, Dict[str, torch.Tensor]]:
        # repro-lint: disable=no-host-coercion-of-device-scalars (rows: the trajectory's host copy)
        for t1, t2 in dict.fromkeys(map(tuple, rows[:, :2].tolist())):
            self.ensure((int(t1), int(t2)))
        dev, r0 = self.device, state.round_idx
        bufs = (self.params, self.opt_state, self.hat)
        _load(bufs, state)
        keys = (_upload_keys(state.draws, self.draws, r0, k,
                             self.keys.numel(), dev)
                if self.draws_anything else None)
        out = {name: torch.empty(k, dtype=t.dtype, device=dev)
               for name, t in self.out.items()}
        leaves, step_bufs = tree_leaves(batches), tree_leaves(self.batch)
        phases = max(len(self.cfg.topology_schedule), 1)
        for i in range(k):
            t1, t2 = int(rows[i, 0]), int(rows[i, 1])
            for buf, leaf in zip(step_bufs, leaves):
                buf[:t1].copy_(leaf[i, :t1])
            if keys is not None:
                self.keys.copy_(keys[i])
            self._sets[(t1, t2)][(r0 + i) % phases].replay(r0 + i)
            for name, v in out.items():
                v[i].copy_(self.out[name])
        return _result(bufs, state, donate, r0 + k), out
