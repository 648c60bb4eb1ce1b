"""The DFL / C-DFL round (paper Algorithms 1 and 2) on the dense engine.

A round is tau1 local SGD steps followed by tau2 gossip steps::

    local update (t in [k]_1):   X_{t+1} = X_t - eta G_t          (Alg. 1 l.4)
    communication (t in [k]_2):  X_{t+1} = X_t C                  (Alg. 1 l.6)

With compression (C-DFL, Alg. 2) each gossip step is one CHOCO-G iteration
over the shared estimates Y::

    X <- X + gamma * Y (C - I)                                    (Alg. 2 l.6)
    q  = Q(X - Y)                                                 (Alg. 2 l.7)
    Y <- Y + q                                                    (Alg. 2 l.11)

Parameters are ``dict[str, Tensor]`` with every leaf stacked ``[N, ...]``,
as the reference pytree. Per-node gradients are ``torch.func.vmap`` of
``torch.func.grad_and_value`` over the loss. The gossip hooks
(``DenseSubstrate.mix`` / ``choco_step``) run the CUDA kernels on the card.
The random compressors draw from the state's RNG seam (``DFLState.draws``,
``repro_torch.core.rng``) by (round, gossip step, leaf), where the
reference folds its keys by round, step and node.

Batches are any dict or tuple of tensors whose leaves lead with
``[tau1, N]``; the loss function receives one node's slice of step t in
the same structure.

Ported from ``repro.core.dfl`` on the dense engine, with static taus and
with dynamic ones (``make_round_fn(..., dynamic_taus=True)``: host-int
step counts bounded by the config's, the executor's round), ``dense_power``
mixing and topology schedules. Participation masks and the batched and
sparse engines raise ``NotImplementedError``; ROADMAP.md queues them.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import mixing as mixing_lib
from repro_torch.core.compression import Compressor, Identity, tree_wire_bits
from repro_torch.core.rng import Draws, GeneratorDraws
from repro_torch.core.substrate import DenseSubstrate, NodeSubstrate
from repro_torch.core.topology import Topology, fully_connected
from repro_torch.core.tree import tree_map
from repro_torch.optim import Optimizer

Params = Dict[str, torch.Tensor]
Batch = Any  # a dict or tuple of tensors, every leaf [tau1, N, ...]
LossFn = Callable[[Params, Any], torch.Tensor]
Taus = Optional[Tuple[int, int]]

__all__ = [
    "DFLConfig",
    "DFLState",
    "d_sgd_config",
    "c_sgd_config",
    "sync_sgd_config",
    "replicate",
    "average_model",
    "consensus_distance",
    "init_state",
    "local_phase",
    "gossip_phase",
    "round_body",
    "make_round_fn",
    "round_wire_bits",
]

_NOT_PORTED = "is not ported yet (ROADMAP.md, modules to port)"


@dataclasses.dataclass(frozen=True)
class DFLConfig:
    """Hyper-parameters of one DFL instance.

    tau1: local update steps per round; tau2: gossip steps per round (the
    maxima when the round takes dynamic taus).
    topology: gossip graph / confusion matrix C.
    mixing_impl: 'dense' (tau2 steps X C) or 'dense_power' (one product
    X C^tau2; plain DFL with static taus only).
    compression: None for plain DFL; a Compressor for C-DFL.
    gamma: CHOCO consensus step size.
    topology_schedule: round k of plain DFL gossips over
    ``topology_schedule[k % len]`` by ``mix_dense`` (C-DFL keeps
    ``topology``, as the reference does).
    """

    tau1: int
    tau2: int
    topology: Topology
    mixing_impl: str = "dense"
    compression: Optional[Compressor] = None
    gamma: float = 1.0
    topology_schedule: Tuple[Topology, ...] = ()

    def __post_init__(self):
        if self.tau1 < 1 or self.tau2 < 0:
            raise ValueError(f"need tau1 >= 1 and tau2 >= 0, got "
                             f"({self.tau1}, {self.tau2})")
        if self.mixing_impl not in ("dense", "dense_power"):
            raise ValueError(f"unknown mixing_impl {self.mixing_impl!r}")
        if self.mixing_impl == "dense_power":
            if self.compression is not None:
                raise ValueError(
                    "C-DFL interleaves compression with every gossip step; "
                    "dense_power mixing is only valid for uncompressed DFL")
            if self.topology_schedule:
                raise ValueError("topology schedules gossip by iterated "
                                 "dense mixing (mixing_impl='dense')")

    @property
    def tau(self) -> int:
        return self.tau1 + self.tau2

    @property
    def is_compressed(self) -> bool:
        return self.compression is not None


def d_sgd_config(topology: Topology, **kw) -> DFLConfig:
    """D-SGD special case: (tau1, tau2) = (1, 1)  [paper Sec. III-C1]."""
    return DFLConfig(tau1=1, tau2=1, topology=topology, **kw)


def c_sgd_config(tau: int, topology: Topology, **kw) -> DFLConfig:
    """C-SGD special case: (tau1, tau2) = (tau, 1)  [paper Sec. III-C2]."""
    return DFLConfig(tau1=tau, tau2=1, topology=topology, **kw)


def sync_sgd_config(num_nodes: int, tau1: int = 1, **kw) -> DFLConfig:
    """Synchronous SGD benchmark: C = J (zeta = 0)  [paper Corollary 1/2]."""
    return DFLConfig(tau1=tau1, tau2=1, topology=fully_connected(num_nodes),
                     **kw)


class DFLState(NamedTuple):
    """Stacked per-node training state."""

    params: Params               # every leaf [N, ...]
    opt_state: dict              # optimizer step and slots per node
    hat_params: Optional[Params]  # CHOCO shared estimates Y (None for DFL)
    round_idx: int
    draws: Optional[Draws] = None  # the RNG seam of the random compressors


def replicate(params: Params, n: int) -> Params:
    """n identical copies along a new leading node axis (all nodes start at
    the same point, Sec. VI-A)."""
    return {name: x.unsqueeze(0).repeat((n,) + (1,) * x.dim())
            for name, x in params.items()}


def average_model(params: Params) -> Params:
    """u_t = X_t 1/N, the paper's average model."""
    return {name: x.mean(dim=0) for name, x in params.items()}


def consensus_distance(params: Params) -> torch.Tensor:
    """||X (I - J)||_F^2 / N, the local drift of Lemma 1, summed over the
    leaves in sorted-name order (the reference's leaf order)."""
    total, n = 0.0, None
    for name in sorted(params):
        leaf = params[name]
        n = leaf.shape[0]
        mean = leaf.mean(dim=0, keepdim=True)
        total = total + torch.sum((leaf.float() - mean) ** 2)
    if n is None:
        raise ValueError("consensus_distance of an empty tree")
    return total / n


def init_state(params: Params, n: int, opt: Optimizer, stacked: bool = False,
               compressed: bool = False, seed: int = 0,
               draws: Optional[Draws] = None) -> DFLState:
    """Stacked state from one model's params (or pre-stacked ones);
    ``compressed`` allocates the CHOCO estimates Y = 0 (Alg. 2 l.1).
    ``draws`` is the RNG seam; by default a ``GeneratorDraws`` from
    ``seed`` on the parameters' device."""
    stacked_params = params if stacked else replicate(params, n)
    hat = ({name: torch.zeros_like(x) for name, x in stacked_params.items()}
           if compressed else None)
    if draws is None:
        device = next(iter(stacked_params.values())).device
        draws = GeneratorDraws(seed, n, stacked_params.keys(), device)
    return DFLState(params=stacked_params, opt_state=opt.init(stacked_params),
                    hat_params=hat, round_idx=0, draws=draws)


def local_phase(cfg: DFLConfig, loss_fn: LossFn, opt: Optimizer,
                sub: NodeSubstrate, params: Params, opt_state: dict,
                batches: Batch, tau1: Optional[int] = None
                ) -> Tuple[Params, dict, torch.Tensor]:
    """tau1 per-node SGD steps (Alg. 1 l.4) on batches [tau1, N, ...];
    returns (params', opt_state', mean loss over steps and nodes).

    ``tau1``: a host int for the dynamic round, which reads only the first
    tau1 steps of batches [cfg.tau1, N, ...] and sums the per-node losses
    l_0 + l_1 + ... before dividing by tau1, as the reference's dynamic
    round does; ``None`` runs cfg.tau1 steps and means the stacked losses.
    The parameters are the same either way."""
    grad_fn = vmap(grad_and_value(loss_fn))
    losses = []
    for t in range(cfg.tau1 if tau1 is None else tau1):
        grads, loss = grad_fn(params, tree_map(lambda b: b[t], batches))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = {name: (p + updates[name]).to(p.dtype)
                  for name, p in params.items()}
        losses.append(loss)
    if tau1 is None:
        per_node = torch.stack(losses).mean(dim=0)
    else:
        per_node = losses[0]
        for loss in losses[1:]:
            per_node = per_node + loss
        per_node = per_node / tau1
    return params, opt_state, sub.mean_over_nodes(per_node)


def _mix_plain(cfg: DFLConfig, sub: NodeSubstrate, params: Params,
               round_idx: int, tau2: Optional[int]) -> Params:
    """tau2 uncompressed gossip steps: over the round's topology of the
    schedule by ``mix_dense``, as one C^tau2 product under 'dense_power',
    else by the substrate's ``mix`` (K1 on a circulant C)."""
    steps = cfg.tau2 if tau2 is None else tau2
    if cfg.topology_schedule:
        topo = cfg.topology_schedule[round_idx % len(cfg.topology_schedule)]
        for _ in range(steps):
            params = mixing_lib.mix_dense(params, topo)
        return params
    if cfg.mixing_impl == "dense_power":
        if tau2 is not None:
            raise ValueError("dense_power folds C^tau2 in when the round is "
                             "built; dynamic taus need mixing_impl='dense'")
        return (mixing_lib.mix_dense_power(params, cfg.topology, steps)
                if steps else params)
    for _ in range(steps):
        params = sub.mix(params)
    return params


def gossip_phase(cfg: DFLConfig, sub: NodeSubstrate, params: Params,
                 hat: Optional[Params], draws: Optional[Draws] = None,
                 round_idx: int = 0, tau2: Optional[int] = None
                 ) -> Tuple[Params, Optional[Params]]:
    """tau2 gossip steps (Alg. 1 l.6), or tau2 CHOCO-G iterations over
    (params, hat) under C-DFL (Alg. 2 l.6-11), step t drawing from
    ``draws`` at (round_idx, t). ``tau2``: a host int for the dynamic
    round (0 allowed), else cfg.tau2. Returns (params', hat')."""
    if not cfg.is_compressed:
        return _mix_plain(cfg, sub, params, round_idx, tau2), hat
    if hat is None:
        raise ValueError("C-DFL needs init_state(..., compressed=True)")
    for t in range(cfg.tau2 if tau2 is None else tau2):
        params, hat = sub.choco_step(cfg.compression, params, hat,
                                     sub.mix(hat), cfg.gamma, draws,
                                     round_idx, t)
    return params, hat


def round_body(cfg: DFLConfig, loss_fn: LossFn, opt: Optimizer,
               sub: NodeSubstrate, params: Params, opt_state: dict,
               hat: Optional[Params], batches: Batch,
               draws: Optional[Draws] = None, round_idx: int = 0,
               taus: Taus = None):
    """One DFL / C-DFL round: (params', opt_state', hat', metrics) with
    metrics ``loss`` (mean local loss) and ``consensus_sq``. ``taus``: the
    dynamic round's host-int (tau1, tau2), bounded by cfg's."""
    tau1, tau2 = taus if taus is not None else (None, None)
    params, opt_state, mean_loss = local_phase(cfg, loss_fn, opt, sub, params,
                                               opt_state, batches, tau1)
    params, hat = gossip_phase(cfg, sub, params, hat, draws, round_idx, tau2)
    metrics = {"loss": mean_loss, "consensus_sq": sub.consensus_sq(params)}
    return params, opt_state, hat, metrics


def check_taus(cfg: DFLConfig, tau1, tau2) -> Tuple[int, int]:
    """(tau1, tau2) as ints within the dynamic round's bounds
    1 <= tau1 <= cfg.tau1 and 0 <= tau2 <= cfg.tau2."""
    tau1, tau2 = operator.index(tau1), operator.index(tau2)
    if not 1 <= tau1 <= cfg.tau1:
        raise ValueError(f"tau1={tau1} outside the bounds [1, {cfg.tau1}]; "
                         "rebuild with a larger tau1 maximum")
    if not 0 <= tau2 <= cfg.tau2:
        raise ValueError(f"tau2={tau2} outside the bounds [0, {cfg.tau2}]; "
                         "rebuild with a larger tau2 maximum")
    return tau1, tau2


def make_round_fn(cfg: DFLConfig, loss_fn: LossFn, opt: Optimizer, *,
                  engine: str = "dense", dynamic_taus: bool = False,
                  participation: bool = False,
                  population: Optional[int] = None):
    """round_fn(state, batches) -> (state', metrics) on the dense engine;
    batch leaves [tau1, N, B, ...].

    ``dynamic_taus``: round_fn(state, batches, tau1, tau2) with host-int
    step counts; cfg.tau1 / cfg.tau2 become the maxima (batch leaves
    [cfg.tau1, N, ...], only the first tau1 steps read). One built round
    serves every (tau1, tau2) within them; its state is bitwise the static
    round's at the same taus, its loss metric within an ulp."""
    if dynamic_taus and cfg.mixing_impl == "dense_power":
        raise ValueError(
            "dynamic taus need iterated mixing: dense_power folds C^tau2 in "
            "when the round is built (use mixing_impl='dense')")
    if engine != "dense":
        raise NotImplementedError(f"engine={engine!r} {_NOT_PORTED}")
    for flag, name in ((participation, "participation"),
                       (population is not None, "population")):
        if flag:
            raise NotImplementedError(f"{name} {_NOT_PORTED}")
    sub = DenseSubstrate(cfg.topology)

    def body(state: DFLState, batches: Batch, taus: Taus):
        params, opt_state, hat, metrics = round_body(
            cfg, loss_fn, opt, sub, state.params, state.opt_state,
            state.hat_params, batches, state.draws, state.round_idx, taus)
        return DFLState(params, opt_state, hat, state.round_idx + 1,
                        state.draws), metrics

    if dynamic_taus:
        def round_fn(state: DFLState, batches: Batch, tau1: int, tau2: int):
            return body(state, batches, check_taus(cfg, tau1, tau2))
    else:
        def round_fn(state: DFLState, batches: Batch):
            return body(state, batches, None)

    return round_fn


def round_wire_bits(cfg: DFLConfig, params_one_node,
                    engine: str = "sparse") -> float:
    """Analytic wire bits per node per round (tau2 gossip steps): the
    compressor's bits per copy times ``mixing.gossip_copies_per_step``."""
    comp = cfg.compression if cfg.is_compressed else Identity()
    copies = mixing_lib.gossip_copies_per_step(cfg.topology, engine)
    return tree_wire_bits(comp, params_one_node) * copies * cfg.tau2
