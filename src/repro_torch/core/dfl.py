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
mixing, topology schedules, participation masks (``round_body(...,
masks=(node_mask, edge_mask))``: host 0/1 arrays; a masked node skips its
local steps and keeps its state, a masked edge gossips nothing and its
weight returns to the endpoints' self loops), the node-batched engine
over a virtual population (``make_round_fn(..., population=V)``) and the
one-round-stale pipeline (``make_pipeline_fns``: round k's local steps,
round k-1's exchange folded one round late), and the sparse engine, one
node per process of a ``torch.distributed`` group
(``make_round_fn(..., engine="sparse", group=...)``, ``core.sharded``):
the same ``round_body`` on a ``ShardedSubstrate``, every leaf the rank's
``[1, ...]`` row. On the gossip-fsdp mesh (``make_round_fn(...,
substrate=MeshSubstrate(...))``, ``launch.steps``) the dense engine runs
on every rank over its blocks of all N nodes; the local step reaches the
weights through the substrate's seam (``NodeSubstrate.node_grads``),
which gathers them whole and reduces the gradients back to the blocks.
On a mesh whose node axes enumerate the nodes (gossip-dp; gossip-fsdp on
pods: ``substrate=NodeMeshSubstrate(...)``) the same round runs on every
rank over its block of its own node's row.
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
from repro_torch.core.substrate import (BatchedSubstrate, DenseSubstrate,
                                        NodeSubstrate, ShardedSubstrate)
from repro_torch.core.topology import Topology, fully_connected
from repro_torch.core.tree import leaf_order, tree_map
from repro_torch.optim import Optimizer

Params = Dict[str, torch.Tensor]
Batch = Any  # a dict or tuple of tensors, every leaf [tau1, N, ...]
LossFn = Callable[[Params, Any], torch.Tensor]
Taus = Optional[Tuple[int, int]]
Masks = Optional[Tuple[Any, Any]]  # (node_mask [N], edge_mask [E]), host 0/1

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
    "pipeline_round_body",
    "pipeline_drain_body",
    "make_pipeline_fns",
    "check_sparse",
    "sparse_engine_eligible",
    "round_wire_bits",
]


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
    leaves in the reference's leaf order (``tree.leaf_order``)."""
    total, n = 0.0, None
    for name in leaf_order(params):
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
                batches: Batch, tau1: Optional[int] = None,
                node_mask=None) -> Tuple[Params, dict, torch.Tensor]:
    """tau1 per-node SGD steps (Alg. 1 l.4) on batches [tau1, N, ...];
    returns (params', opt_state', mean loss over steps and nodes).

    ``tau1``: a host int for the dynamic round, which reads only the first
    tau1 steps of batches [cfg.tau1, N, ...] and sums the per-node losses
    l_0 + l_1 + ... before dividing by tau1, as the reference's dynamic
    round does; ``None`` runs cfg.tau1 steps and means the stacked losses.
    The parameters are the same either way. The sum is divided by tau1 as
    a tensor on its device (``loss_over_tau1``), the one form the captured
    rounds of the executor can share.

    ``node_mask``: the substrate-local participation mask
    (``sub.node_mask_local``). Every node runs the steps; a masked node
    keeps its old parameters and optimizer state, step count included, so
    its schedule does not advance (``sub.select_nodes``), and the loss is
    the mean over active nodes.

    The gradients come through the substrate's seam
    (``sub.node_grads``): the vmapped call itself on whole parameters, a
    gather before it and a reduction to the blocks after it on the mesh;
    the optimizer then updates what the substrate holds."""
    grad_fn = vmap(grad_and_value(loss_fn))
    params0, opt_state0 = params, opt_state
    losses = []
    for t in range(cfg.tau1 if tau1 is None else tau1):
        grads, loss = sub.node_grads(grad_fn, params,
                                     tree_map(lambda b: b[t], batches))
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
        per_node = loss_over_tau1(per_node, torch.full(
            (), tau1, dtype=per_node.dtype, device=per_node.device))
    if node_mask is None:
        return params, opt_state, sub.mean_over_nodes(per_node)
    params = sub.select_nodes(node_mask, params, params0)
    opt_state = sub.select_nodes(node_mask, opt_state, opt_state0)
    return params, opt_state, sub.masked_mean_over_nodes(per_node, node_mask)


def loss_over_tau1(loss_sum: torch.Tensor,
                   tau1: torch.Tensor) -> torch.Tensor:
    """The dynamic round's per-node loss: the sum over its steps divided by
    ``tau1``, a tensor on the sum's device. True division, as the CPU and
    the reference compute it; dividing a CUDA tensor by a host number would
    multiply by its rounded reciprocal instead (one ulp off for tau1 = 3),
    and a captured graph cannot take a host number that changes."""
    return loss_sum / tau1


def _mix_plain(cfg: DFLConfig, sub: NodeSubstrate, params: Params,
               round_idx: int, tau2: Optional[int],
               edge_mask=None) -> Params:
    """tau2 uncompressed gossip steps: over the round's topology of the
    schedule by ``mix_dense``, as one C^tau2 product under 'dense_power',
    else by the substrate's ``mix`` (K1 on a circulant C), with the
    round's ``edge_mask``."""
    steps = cfg.tau2 if tau2 is None else tau2
    if edge_mask is not None and (cfg.topology_schedule
                                  or cfg.mixing_impl == "dense_power"):
        raise ValueError(
            "participation masks index cfg.topology.edges() and need "
            "iterated mixing: no topology schedule, no dense_power")
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
        params = sub.mix(params, edge_mask)
    return params


def gossip_phase(cfg: DFLConfig, sub: NodeSubstrate, params: Params,
                 hat: Optional[Params], draws: Optional[Draws] = None,
                 round_idx: int = 0, tau2: Optional[int] = None,
                 edge_mask=None) -> Tuple[Params, Optional[Params]]:
    """tau2 gossip steps (Alg. 1 l.6), or tau2 CHOCO-G iterations over
    (params, hat) under C-DFL (Alg. 2 l.6-11), step t drawing from
    ``draws`` at (round_idx, t). ``tau2``: a host int for the dynamic
    round (0 allowed), else cfg.tau2. ``edge_mask``: the round's [E] host
    0/1 mask over ``cfg.topology.edges()``, which gates every mix (under
    C-DFL the mix of the estimates). Returns (params', hat')."""
    if not cfg.is_compressed:
        return _mix_plain(cfg, sub, params, round_idx, tau2, edge_mask), hat
    if hat is None:
        raise ValueError("C-DFL needs init_state(..., compressed=True)")
    for t in range(cfg.tau2 if tau2 is None else tau2):
        params, hat = sub.choco_step(cfg.compression, params, hat,
                                     sub.mix(hat, edge_mask), cfg.gamma,
                                     draws, round_idx, t)
    return params, hat


def round_body(cfg: DFLConfig, loss_fn: LossFn, opt: Optimizer,
               sub: NodeSubstrate, params: Params, opt_state: dict,
               hat: Optional[Params], batches: Batch,
               draws: Optional[Draws] = None, round_idx: int = 0,
               taus: Taus = None, masks: Masks = None):
    """One DFL / C-DFL round: (params', opt_state', hat', metrics) with
    metrics ``loss`` (mean local loss over active nodes) and
    ``consensus_sq``. ``taus``: the dynamic round's host-int (tau1, tau2),
    bounded by cfg's. ``masks``: the sporadic round's host 0/1 ``(node_mask
    [N], edge_mask [E])``; all ones is bitwise the unmasked round."""
    tau1, tau2 = taus if taus is not None else (None, None)
    if masks is not None:
        node_mask, edge_mask = masks
        node_mask = sub.node_mask_local(node_mask)
    else:
        node_mask = edge_mask = None
    params, opt_state, mean_loss = local_phase(cfg, loss_fn, opt, sub, params,
                                               opt_state, batches, tau1,
                                               node_mask)
    params, hat = gossip_phase(cfg, sub, params, hat, draws, round_idx, tau2,
                               edge_mask)
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
                  population: Optional[int] = None, group=None,
                  substrate: Optional[NodeSubstrate] = None):
    """round_fn(state, batches) -> (state', metrics) on the dense engine;
    batch leaves [tau1, N, B, ...].

    ``dynamic_taus``: round_fn(state, batches, tau1, tau2) with host-int
    step counts; cfg.tau1 / cfg.tau2 become the maxima (batch leaves
    [cfg.tau1, N, ...], only the first tau1 steps read). One built round
    serves every (tau1, tau2) within them; its state is bitwise the static
    round's at the same taus, its loss metric within an ulp.

    ``participation``: round_fn(state, batches, tau1, tau2, node_mask,
    edge_mask) with host 0/1 masks ([N] over nodes, [E] over
    ``cfg.topology.edges()``), the sporadic round of ``round_body(...,
    masks=...)``. Needs ``dynamic_taus`` and iterated mixing over one
    topology (no ``dense_power``, no topology schedule).

    ``population``: the node-batched engine (``engine="batched"``, or
    "auto"). State leaves are stacked ``[population, ...]`` and
    ``cfg.topology`` is the C-node cohort graph; round_fn(state, batches,
    tau1, tau2, cohort_ids, node_mask, edge_mask) with ``[C]`` host global
    ids gathers the cohort's rows, runs ``round_body`` over them with the
    seam drawing by global id, and writes them back into the state's own
    tensors in place (rows outside the cohort untouched). The identity
    cohort at full population is bitwise the dense round. Implies the
    participation constraints.

    ``group``: the sparse engine (``engine="sparse"``, or "auto" when
    ``sparse_engine_eligible``), one node per rank of a
    ``core.sharded.NodeGroup``: the same signatures, state leaves
    ``[1, ...]`` and batch leaves ``[tau1, 1, ...]`` of this rank's node
    (``core.sharded.local_rows``), the round over a ``ShardedSubstrate``.
    Every rank calls it the same number of times with the same host taus
    and masks. Misuse raises ``ValueError`` with the reference's reasons
    (``check_sparse``).

    ``substrate``: the round over a mesh's substrate: the gossip-fsdp
    mesh's ``MeshSubstrate`` (every rank its blocks of all N nodes; batch
    leaves ``[tau1, N, B / data, ...]``, this rank's part of each node's
    batch) or ``NodeMeshSubstrate`` (gossip-dp, gossip-fsdp on pods: its
    block of its node; batch leaves ``[tau1, 1, B', ...]``, its part of
    its node's batch: whole in gossip-dp, B / data on pods). Every
    rank calls it alike, as on the sparse engine.
    """
    if dynamic_taus and cfg.mixing_impl == "dense_power":
        raise ValueError(
            "dynamic taus need iterated mixing: dense_power folds C^tau2 in "
            "when the round is built (use mixing_impl='dense')")
    if participation or population is not None:
        if not dynamic_taus:
            raise ValueError("participation masks ride the dynamic "
                             "schedule-as-data path; pass dynamic_taus=True")
        if cfg.topology_schedule:
            raise ValueError("participation masks index cfg.topology.edges(); "
                             "a round-varying topology schedule has no "
                             "stable edge list")
    if substrate is not None:
        return round_fn_over(cfg, loss_fn, opt,
                             _given_substrate(cfg, engine, substrate,
                                              population, group),
                             dynamic_taus=dynamic_taus,
                             participation=participation)
    if engine == "auto":
        engine = ("batched" if population is not None else "sparse"
                  if sparse_engine_eligible(cfg, group) else "dense")
    if engine not in ("dense", "batched", "sparse"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "batched":
        if population is None:
            raise ValueError("engine='batched' needs population=V (the "
                             "virtual node count the state is stacked over)")
        base = BatchedSubstrate(cfg.topology, population)

        def batched_round_fn(state: DFLState, batches: Batch, tau1: int,
                             tau2: int, cohort_ids, node_mask, edge_mask):
            taus = check_taus(cfg, tau1, tau2)
            sub = base.with_cohort(cohort_ids)
            params, opt_state, hat, metrics = round_body(
                cfg, loss_fn, opt, sub, sub.gather_cohort(state.params),
                sub.gather_cohort(state.opt_state),
                sub.gather_cohort(state.hat_params), batches, state.draws,
                state.round_idx, taus, (node_mask, edge_mask))
            return DFLState(
                sub.scatter_cohort(state.params, params),
                sub.scatter_cohort(state.opt_state, opt_state),
                sub.scatter_cohort(state.hat_params, hat),
                state.round_idx + 1, state.draws), metrics

        return batched_round_fn
    if population is not None:
        raise ValueError(f"population= is a batched-engine parameter (got "
                         f"engine={engine!r}); the {engine} engine's node "
                         "count is the topology's")
    if engine == "sparse":
        check_sparse(cfg, group)
        sub = ShardedSubstrate(cfg.topology, group)
    else:
        sub = DenseSubstrate(cfg.topology)
    return round_fn_over(cfg, loss_fn, opt, sub, dynamic_taus=dynamic_taus,
                         participation=participation)


def _given_substrate(cfg: DFLConfig, engine: str, substrate: NodeSubstrate,
                     population=None, group=None) -> NodeSubstrate:
    """``substrate`` checked to be a dense-engine substrate of the config's
    nodes."""
    if engine not in ("dense", "auto"):
        raise ValueError(f"a given substrate runs the dense engine, not "
                         f"engine={engine!r}")
    if population is not None or group is not None:
        raise ValueError("a given substrate takes neither population= nor "
                         "group=")
    if substrate.num_nodes != cfg.topology.num_nodes:
        raise ValueError(f"the substrate holds {substrate.num_nodes} nodes, "
                         f"the topology has {cfg.topology.num_nodes}")
    if isinstance(substrate, ShardedSubstrate) and (
            cfg.topology_schedule or cfg.mixing_impl == "dense_power"):
        raise ValueError("a substrate of one node a rank mixes one "
                         "topology by iterated steps: no topology schedule, "
                         "no dense_power")
    return substrate


def round_fn_over(cfg: DFLConfig, loss_fn: LossFn, opt: Optimizer,
                  sub: NodeSubstrate, *, dynamic_taus: bool = False,
                  participation: bool = False):
    """``make_round_fn``'s round over the substrate ``sub`` (dense or
    sharded), static, dynamic or with participation masks."""
    def body(state: DFLState, batches: Batch, taus: Taus, masks: Masks = None):
        params, opt_state, hat, metrics = round_body(
            cfg, loss_fn, opt, sub, state.params, state.opt_state,
            state.hat_params, batches, state.draws, state.round_idx, taus,
            masks)
        return DFLState(params, opt_state, hat, state.round_idx + 1,
                        state.draws), metrics

    if participation:
        def round_fn(state: DFLState, batches: Batch, tau1: int, tau2: int,
                     node_mask, edge_mask):
            return body(state, batches, check_taus(cfg, tau1, tau2),
                        (node_mask, edge_mask))
    elif dynamic_taus:
        def round_fn(state: DFLState, batches: Batch, tau1: int, tau2: int):
            return body(state, batches, check_taus(cfg, tau1, tau2))
    else:
        def round_fn(state: DFLState, batches: Batch):
            return body(state, batches, None)

    return round_fn


def pipeline_round_body(cfg: DFLConfig, loss_fn: LossFn, opt: Optimizer,
                        sub: NodeSubstrate, params: Params, opt_state: dict,
                        hat: Optional[Params], draws: Optional[Draws],
                        round_idx: int, buf: Params, have: bool, tau1: int,
                        prev_tau2: int, batches: Batch, node_mask=None,
                        prev_edge_mask=None):
    """One overlapped round (``overlap="pipeline"``): round k's local phase
    and the one-round-stale fold of round k-1's gossip exchange::

        z_k = local_phase(p_k, batches_k)         round k's tau1 steps
        g   = gossip_phase(buf = z_{k-1})         round k-1's exchange,
                                                  independent of z_k
        p_{k+1} = z_k + (g - z_{k-1})             folded one round late

    The exchange runs with round k-1's draws (at ``round_idx - 1``), trip
    count ``prev_tau2`` and edge mask ``prev_edge_mask``, so a pipelined
    run applies the same gossip operators as the legacy run, each one round
    later. ``have`` is False on a superstep's first round, whose exchange
    (of nothing: ``prev_tau2`` is 0 there) is not folded: ``p_{k+1} =
    z_k``. The CHOCO estimates ride the exchanges. Host ints and masks, as
    ``round_body``'s. Returns (params', opt_state', hat', buf' = z_k,
    metrics): the loss is round k's, ``consensus_sq`` that of the folded
    params."""
    mask_local = None if node_mask is None else sub.node_mask_local(
        node_mask)
    z, opt_state, mean_loss = local_phase(cfg, loss_fn, opt, sub, params,
                                          opt_state, batches, tau1,
                                          mask_local)
    if have:
        g, hat = gossip_phase(cfg, sub, buf, hat, draws, round_idx - 1,
                              prev_tau2, prev_edge_mask)
        params = {name: (zl + (g[name] - buf[name])).to(zl.dtype)
                  for name, zl in z.items()}
    else:
        params = z
    metrics = {"loss": mean_loss, "consensus_sq": sub.consensus_sq(params)}
    return params, opt_state, hat, z, metrics


def pipeline_drain_body(cfg: DFLConfig, sub: NodeSubstrate, params: Params,
                        hat: Optional[Params], draws: Optional[Draws],
                        round_idx: int, buf: Params, prev_tau2: int,
                        prev_edge_mask=None):
    """Retire the exchange still in flight after a pipelined superstep:
    ``round_idx`` is the counter after it, so the exchange is round
    ``round_idx - 1``'s. A dispatch ends drained: no gossip crosses a
    dispatch or checkpoint boundary. Returns (params', hat')."""
    g, hat = gossip_phase(cfg, sub, buf, hat, draws, round_idx - 1,
                          prev_tau2, prev_edge_mask)
    return {name: (p + (g[name] - buf[name])).to(p.dtype)
            for name, p in params.items()}, hat


def check_pipeline(cfg: DFLConfig, engine: str = "dense",
                   participation: bool = False) -> None:
    """The configurations the pipeline refuses, with the reference's
    messages."""
    if cfg.mixing_impl == "dense_power":
        raise ValueError(
            "overlap='pipeline' is dynamic-only: dense_power bakes C^tau2 "
            "in at trace time (use mixing_impl='dense')")
    if engine == "batched":
        raise ValueError(
            "overlap='pipeline' is not supported on the batched engine: "
            "consecutive rounds gossip over DIFFERENT sampled cohorts, so "
            "the in-flight exchange has no stable buffer to double-buffer "
            "(use overlap='none')")
    if participation and cfg.topology_schedule:
        raise ValueError(
            "participation masks index cfg.topology.edges(); a "
            "round-varying topology schedule has no stable edge list")
    if engine not in ("dense", "auto", "sparse"):
        raise ValueError(f"unknown engine {engine!r}")


def make_pipeline_fns(cfg: DFLConfig, loss_fn: LossFn, opt: Optimizer, *,
                      engine: str = "dense", participation: bool = False,
                      group=None):
    """The pipelined-round pair (``overlap="pipeline"``;
    ``core.executor.make_pipeline_superstep`` runs ``pipe_fn`` per round
    and ``drain_fn`` once after)::

        pipe_fn(state, buf, have, prev_tau2, batches, tau1)
            -> (state', buf', metrics)                       plain
        pipe_fn(state, buf, have, prev_tau2, prev_edge_mask, batches,
                tau1, node_mask) -> (state', buf', metrics)  participation
        drain_fn(state, buf, prev_tau2[, prev_edge_mask]) -> state'

    Host ints and 0/1 host masks; cfg.tau1 / cfg.tau2 are the maxima, as
    in the dynamic round. The current round's (tau2, edge mask) never enter
    ``pipe_fn``: that exchange runs one round later. ``engine="sparse"``
    (or "auto" when ``sparse_engine_eligible``) with ``group``: the same
    pair on this rank's ``[1, ...]`` node; the in-flight buffer is this
    rank's ``[1, ...]`` tree, and the superstep's first exchange,
    discarded, still makes every send and receive on every rank."""
    check_pipeline(cfg, engine, participation)
    if engine == "auto":
        engine = "sparse" if sparse_engine_eligible(cfg, group) else "dense"
    if engine == "sparse":
        check_sparse(cfg, group)
        sub = ShardedSubstrate(cfg.topology, group)
    else:
        sub = DenseSubstrate(cfg.topology)
    return pipeline_fns_over(cfg, loss_fn, opt, sub,
                             participation=participation)


def pipeline_fns_over(cfg: DFLConfig, loss_fn: LossFn, opt: Optimizer,
                      sub: NodeSubstrate, *, participation: bool = False):
    """``make_pipeline_fns``' pair over the substrate ``sub``."""
    def pipe_body(state, buf, have, prev_tau2, batches, tau1, node_mask=None,
                  prev_edge_mask=None):
        tau1, prev_tau2 = check_taus(cfg, tau1, prev_tau2)
        params, opt_state, hat, z, metrics = pipeline_round_body(
            cfg, loss_fn, opt, sub, state.params, state.opt_state,
            state.hat_params, state.draws, state.round_idx, buf, bool(have),
            tau1, prev_tau2, batches, node_mask, prev_edge_mask)
        return DFLState(params, opt_state, hat, state.round_idx + 1,
                        state.draws), z, metrics

    def drain_body(state, buf, prev_tau2, prev_edge_mask=None):
        _, prev_tau2 = check_taus(cfg, 1, prev_tau2)
        params, hat = pipeline_drain_body(
            cfg, sub, state.params, state.hat_params, state.draws,
            state.round_idx, buf, prev_tau2, prev_edge_mask)
        return state._replace(params=params, hat_params=hat)

    if participation:
        def pipe_fn(state, buf, have, prev_tau2, prev_edge_mask, batches,
                    tau1, node_mask):
            return pipe_body(state, buf, have, prev_tau2, batches, tau1,
                             node_mask, prev_edge_mask)

        def drain_fn(state, buf, prev_tau2, prev_edge_mask):
            return drain_body(state, buf, prev_tau2, prev_edge_mask)
    else:
        def pipe_fn(state, buf, have, prev_tau2, batches, tau1):
            return pipe_body(state, buf, have, prev_tau2, batches, tau1)

        def drain_fn(state, buf, prev_tau2):
            return drain_body(state, buf, prev_tau2)

    return pipe_fn, drain_fn


def _sparse_refusal(cfg: DFLConfig, group) -> Optional[str]:
    """Why the sparse engine cannot run ``cfg`` on ``group``, in the
    reference's words, or None when it can."""
    topo = cfg.topology
    if group is None:
        return ("sparse engine needs a process group, one rank per node "
                "(group=core.sharded.NodeGroup)")
    if not topo.is_shift_structured():
        return (f"{topo.name} is not circulant; use the dense engine "
                "(core.dfl.make_round_fn) for arbitrary topologies")
    if group.world != topo.num_nodes:
        return (f"the process group has {group.world} ranks but {topo.name} "
                f"has {topo.num_nodes} nodes; one node per rank would "
                "silently drop nodes")
    if cfg.topology_schedule or cfg.mixing_impl != "dense":
        return ("the sparse engine gossips over one circulant topology by "
                "iterated mixing: a topology schedule or dense_power needs "
                "the dense engine")
    return None


def check_sparse(cfg: DFLConfig, group) -> None:
    """The sparse engine's preconditions, with the reference's reasons
    (``ValueError``): a group (``core.sharded.NodeGroup``) of exactly N
    ranks, a circulant C, and iterated mixing over one topology."""
    reason = _sparse_refusal(cfg, group)
    if reason is not None:
        raise ValueError(reason)


def sparse_engine_eligible(cfg: DFLConfig, group) -> bool:
    """True when "auto" takes the sparse engine: ``check_sparse`` passes
    and there is more than one node."""
    return (cfg.topology.num_nodes > 1
            and _sparse_refusal(cfg, group) is None)


def round_wire_bits(cfg: DFLConfig, params_one_node,
                    engine: str = "sparse") -> float:
    """Analytic wire bits per node per round (tau2 gossip steps): the
    compressor's bits per copy times ``mixing.gossip_copies_per_step``."""
    comp = cfg.compression if cfg.is_compressed else Identity()
    copies = mixing_lib.gossip_copies_per_step(cfg.topology, engine)
    return tree_wire_bits(comp, params_one_node) * copies * cfg.tau2
