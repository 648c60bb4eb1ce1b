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

Ported from ``repro.core.dfl`` with static taus on the dense engine. The
executor's dynamic taus, participation masks, ``dense_power`` mixing,
topology schedules, and the batched and sparse engines raise
``NotImplementedError``; ROADMAP.md queues them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import mixing as mixing_lib
from repro_torch.core.compression import Compressor, Identity, tree_wire_bits
from repro_torch.core.rng import Draws, GeneratorDraws
from repro_torch.core.substrate import DenseSubstrate, NodeSubstrate
from repro_torch.core.topology import Topology
from repro_torch.optim import Optimizer

Params = Dict[str, torch.Tensor]
Batch = Tuple[torch.Tensor, torch.Tensor]
LossFn = Callable[[Params, Batch], torch.Tensor]

__all__ = [
    "DFLConfig",
    "DFLState",
    "replicate",
    "average_model",
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

    tau1: local update steps per round; tau2: gossip steps per round.
    topology: gossip graph / confusion matrix C.
    compression: None for plain DFL; a Compressor for C-DFL.
    gamma: CHOCO consensus step size.
    mixing_impl, topology_schedule: the reference's 'dense_power' mixing
    and round-varying topologies, not ported yet (they raise).
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
        if self.mixing_impl != "dense":
            raise NotImplementedError(
                f"mixing_impl={self.mixing_impl!r} {_NOT_PORTED}")
        if self.topology_schedule:
            raise NotImplementedError(f"topology_schedule {_NOT_PORTED}")

    @property
    def is_compressed(self) -> bool:
        return self.compression is not None


class DFLState(NamedTuple):
    """Stacked per-node training state."""

    params: Params               # every leaf [N, ...]
    opt_state: Params            # optimizer slots per node
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
                sub: NodeSubstrate, params: Params, opt_state: Params,
                batches: Batch) -> Tuple[Params, Params, torch.Tensor]:
    """tau1 per-node SGD steps (Alg. 1 l.4) on batches [tau1, N, ...];
    returns (params', opt_state', mean loss over steps and nodes)."""
    grad_fn = vmap(grad_and_value(loss_fn))
    xs, ys = batches
    losses = []
    for t in range(cfg.tau1):
        grads, loss = grad_fn(params, (xs[t], ys[t]))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = {name: (p + updates[name]).to(p.dtype)
                  for name, p in params.items()}
        losses.append(loss)
    return params, opt_state, sub.mean_over_nodes(
        torch.stack(losses).mean(dim=0))


def gossip_phase(cfg: DFLConfig, sub: NodeSubstrate, params: Params,
                 hat: Optional[Params], draws: Optional[Draws] = None,
                 round_idx: int = 0) -> Tuple[Params, Optional[Params]]:
    """tau2 gossip steps (Alg. 1 l.6), or tau2 CHOCO-G iterations over
    (params, hat) under C-DFL (Alg. 2 l.6-11), step t drawing from
    ``draws`` at (round_idx, t). Returns (params', hat')."""
    if not cfg.is_compressed:
        for _ in range(cfg.tau2):
            params = sub.mix(params)
        return params, hat
    if hat is None:
        raise ValueError("C-DFL needs init_state(..., compressed=True)")
    for t in range(cfg.tau2):
        params, hat = sub.choco_step(cfg.compression, params, hat,
                                     sub.mix(hat), cfg.gamma, draws,
                                     round_idx, t)
    return params, hat


def round_body(cfg: DFLConfig, loss_fn: LossFn, opt: Optimizer,
               sub: NodeSubstrate, params: Params, opt_state: Params,
               hat: Optional[Params], batches: Batch,
               draws: Optional[Draws] = None, round_idx: int = 0):
    """One DFL / C-DFL round: (params', opt_state', hat', metrics) with
    metrics ``loss`` (mean local loss) and ``consensus_sq``."""
    params, opt_state, mean_loss = local_phase(cfg, loss_fn, opt, sub, params,
                                               opt_state, batches)
    params, hat = gossip_phase(cfg, sub, params, hat, draws, round_idx)
    metrics = {"loss": mean_loss, "consensus_sq": sub.consensus_sq(params)}
    return params, opt_state, hat, metrics


def make_round_fn(cfg: DFLConfig, loss_fn: LossFn, opt: Optimizer, *,
                  engine: str = "dense", dynamic_taus: bool = False,
                  participation: bool = False,
                  population: Optional[int] = None):
    """round_fn(state, batches) -> (state', metrics) on the dense engine;
    batches (x [tau1, N, B, ...], y [tau1, N, B])."""
    if engine != "dense":
        raise NotImplementedError(f"engine={engine!r} {_NOT_PORTED}")
    for flag, name in ((dynamic_taus, "dynamic_taus"),
                       (participation, "participation"),
                       (population is not None, "population")):
        if flag:
            raise NotImplementedError(f"{name} {_NOT_PORTED}")
    sub = DenseSubstrate(cfg.topology)

    def round_fn(state: DFLState, batches: Batch):
        params, opt_state, hat, metrics = round_body(
            cfg, loss_fn, opt, sub, state.params, state.opt_state,
            state.hat_params, batches, state.draws, state.round_idx)
        return DFLState(params, opt_state, hat, state.round_idx + 1,
                        state.draws), metrics

    return round_fn


def round_wire_bits(cfg: DFLConfig, params_one_node,
                    engine: str = "sparse") -> float:
    """Analytic wire bits per node per round (tau2 gossip steps): the
    compressor's bits per copy times ``mixing.gossip_copies_per_step``."""
    comp = cfg.compression if cfg.is_compressed else Identity()
    copies = mixing_lib.gossip_copies_per_step(cfg.topology, engine)
    return tree_wire_bits(comp, params_one_node) * copies * cfg.tau2
