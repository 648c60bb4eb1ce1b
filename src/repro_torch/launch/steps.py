"""Builders of the launcher: unit steps, their roofline counts, and the
planned DFL round.

Ported from ``repro.launch.steps``. The reference builds jitted functions
with abstract arguments and lowers them; the port builds callables that
run on the device (``Built``: ``fn(*args)``), from the same machinery the
train CLI uses (``core.dfl`` / ``RoundExecutor``), so a round on the card
launches the kernels: K1 for a plain gossip step, K4 + K3 under TopK, K2
under QSGD. Where the reference takes a mesh, the port takes ``nodes``:
an int (every node stacked ``[N, ...]`` on one device, the dense engine),
this rank's ``core.sharded.NodeGroup`` (one node a process, the sparse
engine), or a ``launch.mesh.Mesh`` of ranks (``make_host_mesh``), as the
reference's functions here take one, placing each leaf by the architecture's
``sharding_mode`` (``launch.sharding``). The port runs both modes on a
single-pod ``(data, model)`` mesh and on a multi-pod ``(pod, data,
model)`` one (``make_host_mesh(data, model, pod=)``; ``dfl_setup``,
``select_engine``), every rank calling these functions alike:

  * gossip-fsdp on one pod: the arch's ``fsdp_nodes`` nodes, replicated
    on every rank, each leaf a block of every node over (``data``,
    ``model``), each node's batch split over ``data``; the round on
    ``core.substrate.MeshSubstrate``;
  * gossip-fsdp on pods (hierarchical DFL): a node a pod, the rank holding
    its pod's block over (``data``, ``model``) of every leaf and its part
    of the node's batch, split over ``data``;
  * gossip-dp: a node a ``data`` coordinate (a (``pod``, ``data``) pair on
    pods), the rank holding its node's block over ``model`` of every leaf
    and the node's whole batch.

Where the mesh has node axes (gossip-dp, gossip-fsdp on pods) the round
runs on ``core.substrate.NodeMeshSubstrate``: the shift exchange over the
node axes, the rows' reductions over the rest.

  * ``build_local_step``  ONE local SGD step on all of a device's nodes:
                          the roofline's compute unit.
  * ``build_gossip_step`` ONE gossip step (or CHOCO-G iteration): the
                          collective unit.
  * ``roofline_cost_inputs`` the planner's MEASURED cost inputs: the local
                          step counted on ``meta`` tensors
                          (``launch.roofline.analyze_step``), and the bytes
                          a gossip step exchanges.
  * ``plan_train_schedule`` (tau1, tau2) from ``planner.plan``, priced
                          analytically or from those counts.
  * ``build_train_round`` / ``build_planned_round`` the round on the
                          executor, at given or planned (tau1, tau2).

As in the reference, rounds compose analytically from unit steps: round =
tau1 * local + tau2 * gossip. Model and batch come from the architecture
and the input shape (``configs.base.SHAPES``); ``cfg=``, ``batch=`` (a
node's batch) and ``seq=`` override them, so any ``ModelConfig`` can be
priced at any size. A reduced config at a shape's own sequence length
counts slowly: its attention chunks of 16 are a Python loop each.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.core import mixing as mixing_lib
from repro_torch.core.compression import Compressor
from repro_torch.core.dfl import DFLConfig, gossip_phase, init_state, replicate
from repro_torch.core.executor import RoundExecutor, stack_round_batches
from repro_torch.core.rng import GeneratorDraws
from repro_torch.core.sharded import NodeGroup, ShardGroup, local_rows
from repro_torch.core.substrate import (DenseSubstrate, MeshSubstrate,
                                        NodeMeshSubstrate, ShardedSubstrate)
from repro_torch.core.topology import fully_connected, ring, torus
from repro_torch.data.lm import SyntheticLM, lm_batches_for_dfl
from repro_torch.device import resolve_device
from repro_torch.launch import roofline as roof_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ModelConfig, init_params, train_loss
from repro_torch.optim import sgd

__all__ = ["Built", "kernelize_compressor", "dfl_setup", "select_engine",
           "build_local_step", "build_gossip_step", "roofline_cost_inputs",
           "plan_train_schedule", "build_train_round", "build_planned_round"]

Nodes = Union[int, NodeGroup, Mesh]


@dataclasses.dataclass
class Built:
    """A callable that runs on the device, with its arguments: ``fn(*args)``
    (``run()``). ``meta`` describes it (``kind``, ``arch``, ``shape``,
    ``nodes``, and for a round ``tau1``, ``tau2`` and, when planned,
    ``plan``); a round's ``executor`` is the ``RoundExecutor`` it
    dispatches through, which ``warmup()`` builds and captures first, and
    each ``run()`` of a round carries its state on to the next."""

    fn: Callable
    args: Tuple
    meta: Dict[str, Any]
    executor: Optional[RoundExecutor] = None
    substrate: Any = None    # the node substrate the step or round runs on

    def run(self):
        out = self.fn(*self.args)
        if self.executor is not None:
            self.args = (out[0],) + tuple(self.args[1:])
        return out

    def warmup(self) -> None:
        if self.executor is not None:
            self.executor.warmup(*self.args)


def kernelize_compressor(compression: Optional[Compressor],
                         use_kernels: bool) -> Optional[Compressor]:
    """The compressor the round runs with under ``--use-kernels``. In the
    reference the flag routes TopK through the Pallas kernels; in the port
    a tensor on the card always takes the CUDA kernels and one on the CPU
    their plain versions (``kernels/ops.py``), so the flag changes nothing
    and the compressor comes back as it is."""
    del use_kernels
    return compression


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _split(nodes: Nodes, arch: Optional[ArchConfig] = None
           ) -> Tuple[int, Optional[NodeGroup]]:
    """(N, the group or None) of a ``nodes`` argument; a mesh's N is the
    arch's (``sharding.num_nodes_for``)."""
    if isinstance(nodes, NodeGroup):
        return nodes.world, nodes
    if isinstance(nodes, Mesh):
        if arch is None:
            raise ValueError("a mesh's node count comes from the arch")
        return shard_lib.num_nodes_for(arch.sharding_mode, nodes,
                                       arch.fsdp_nodes), None
    return int(nodes), None


def _topology(n: int, topology: str):
    """The reference's ``dfl_setup`` graph: fully connected on one node."""
    if n == 1:
        return fully_connected(1)
    return {
        "ring": ring,
        "full": fully_connected,
        "torus": lambda k: torus(2, k // 2) if k >= 4 else ring(k),
    }[topology](n)


def dfl_setup(arch: ArchConfig, mesh: Mesh, *, tau1: int, tau2: int,
              compression: Optional[Compressor], mixing_impl: str = "dense",
              topology: str = "ring"):
    """(mode, N, the round's ``DFLConfig``) of ``arch`` on ``mesh``: the
    reference's ``dfl_setup``."""
    mode = arch.sharding_mode
    n = shard_lib.num_nodes_for(mode, mesh, arch.fsdp_nodes)
    dcfg = DFLConfig(tau1=tau1, tau2=tau2, topology=_topology(n, topology),
                     mixing_impl=mixing_impl, compression=compression)
    return mode, n, dcfg


def select_engine(engine: str, dcfg: DFLConfig, mesh: Mesh,
                  mode: str) -> str:
    """The reference's engine choice: an explicit one as given; "auto"
    picks the sparse engine only where the node axes enumerate all N > 1
    nodes, every other axis has one rank, and the topology is circulant,
    with one topology mixed by iterated steps; else the dense engine
    (gossip-fsdp on one pod: replicated nodes, always dense)."""
    if engine != "auto":
        return engine
    node_axes = shard_lib.node_axes_for(mode, mesh)
    if not node_axes:
        return "dense"
    if any(mesh.shape[a] > 1 for a in mesh.axis_names if a not in node_axes):
        return "dense"
    n = mesh.axes_size(node_axes)
    topo = dcfg.topology
    eligible = (topo.num_nodes > 1 and topo.num_nodes == n
                and topo.is_shift_structured() and not dcfg.topology_schedule
                and dcfg.mixing_impl == "dense")
    return "sparse" if eligible else "dense"


def _model(arch: ArchConfig, reduced: bool,
           cfg: Optional[ModelConfig]) -> ModelConfig:
    if cfg is not None:
        return cfg
    return arch.reduced if reduced else arch.model


def _batch_shape(arch: ArchConfig, shape_name: str, n: int,
                 batch: Optional[int], seq: Optional[int]) -> Tuple[int, int]:
    """(a node's batch, sequence length): the shape's global batch split
    over the nodes, as the reference's ``_abstract_batch``, unless
    overridden."""
    shape = SHAPES[shape_name]
    per_node = shape.global_batch // n if batch is None else batch
    if per_node < 1:
        raise ValueError(f"{arch.arch_id}/{shape_name}: global batch "
                         f"{shape.global_batch} < {n} nodes")
    return per_node, shape.seq_len if seq is None else seq


def _loss(cfg: ModelConfig) -> Callable:
    def loss_fn(p, b):
        return train_loss(p, b, cfg)
    return loss_fn


def _memory(cfg: ModelConfig, lead: Tuple[int, ...], r: int) -> np.ndarray:
    """The stub frontend embeddings of a model with a memory input, as the
    train CLI makes them."""
    m = cfg.memory_tokens or 16
    return np.random.default_rng(1000 + r).standard_normal(
        lead + (m, cfg.memory_dim or cfg.d_model), dtype=np.float32)


def _params(cfg: ModelConfig, dev: torch.device,
            generator: Optional[torch.Generator]):
    """One model's initial weights on ``dev`` (``meta``: shapes only)."""
    if dev.type == "meta":
        return init_params(cfg, None, dev, abstract=True)[0]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_params(cfg, generator, dev)[0]


def _node_a_rank(arch: ArchConfig, mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` has node axes, a rank holding one node's blocks
    (gossip-dp; gossip-fsdp on pods)."""
    return mesh is not None and bool(
        shard_lib.node_axes_for(arch.sharding_mode, mesh))


def _mesh_parts(arch: ArchConfig, model: ModelConfig, mesh: Mesh, n: int,
                dev: torch.device, generator: Optional[torch.Generator],
                node_chunk: Optional[int], topo):
    """This rank's part of ``n`` copies of one model's initial weights (its
    blocks of every node in gossip-fsdp on one pod, its block of its
    node's ``[1, ...]`` row where the mesh has node axes), and the mesh's
    substrate over them (which holds their specs and whole shapes)."""
    mode = arch.sharding_mode
    node_axes = shard_lib.node_axes_for(mode, mesh)
    group = ShardGroup(mesh, dev, node_axes=node_axes)
    if node_axes and node_chunk is not None:
        raise ValueError("node_chunk= sets a single-pod gossip-fsdp mesh's "
                         f"local step; a rank of nodes over {node_axes} "
                         "steps its one node")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    whole, axes = init_params(model, generator, dev)
    shapes = {name: (n,) + tuple(x.shape) for name, x in whole.items()}
    specs = {name: shard_lib.spec_for_param(axes[name], shapes[name], mode,
                                            mesh, node_dim=True)
             for name in whole}
    rows = 1 if node_axes else n
    params = {}
    for name in list(whole):
        block = shard_lib.shard_leaf(whole.pop(name), specs[name][1:], mesh)
        params[name] = block.unsqueeze(0).repeat((rows,) + (1,) * block.dim())
    if node_axes:
        return params, NodeMeshSubstrate(topo, group, specs, shapes)
    return params, MeshSubstrate(topo, group, specs, shapes, chunk=node_chunk)


def _mesh_batch(tree, mesh: Mesh, mode: str, lead: int):
    """This rank's part of batches ``[*lead dims, N, B, ...]``
    (``sharding.batch_spec``): B split over ``data`` in gossip-fsdp (its
    pod's node's row of that on pods), its node's ``[1, B, ...]`` row in
    gossip-dp."""
    spec = (None,) * lead + shard_lib.batch_spec(mesh, mode,
                                                 has_tau_dim=False)
    return {k: shard_lib.shard_leaf(v, spec, mesh) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Unit steps and their counts
# ---------------------------------------------------------------------------


def build_local_step(arch: ArchConfig, shape_name: str, nodes: Nodes = 1, *,
                     lr: float = 1e-3, reduced: bool = False,
                     cfg: Optional[ModelConfig] = None,
                     batch: Optional[int] = None, seq: Optional[int] = None,
                     device="cuda",
                     generator: Optional[torch.Generator] = None) -> Built:
    """ONE local SGD step on all of this device's nodes (N stacked, or a
    group's one): ``fn(params, opt_state, batch) -> (params', opt_state',
    mean loss)``, each node's gradient by ``vmap(grad)`` as in the round.
    ``device="meta"`` gives shape-only arguments, for counting. On a
    single-pod gossip-fsdp mesh the parameters are this rank's blocks of
    all N nodes and the batch its part of each node's; the step gathers all
    N nodes' weights and keeps its block of the gradients' mean over
    ``data`` (``MeshSubstrate.node_grads``). On a mesh with node axes they
    are its block of its node and its part of that node's batch; the step
    gathers the node's weights over the row axes and keeps its block of
    the gradient, averaged over ``data`` on gossip-fsdp's pods
    (``NodeMeshSubstrate.node_grads``)."""
    model = _model(arch, reduced, cfg)
    n, group = _split(nodes, arch)
    mesh = nodes if isinstance(nodes, Mesh) else None
    rows = 1 if group is not None or _node_a_rank(arch, mesh) else n
    b, s = _batch_shape(arch, shape_name, n, batch, seq)
    if str(device) == "meta":
        if mesh is not None:
            raise ValueError("a mesh's local step runs collectives; count "
                             "its nodes' step with nodes=N")
        dev = torch.device("meta")
    else:
        dev = group.device if group is not None else resolve_device(device)
    opt = sgd(lr)
    sub = None
    if mesh is not None:
        params, sub = _mesh_parts(arch, model, mesh, n, dev, generator,
                                  None, _topology(n, "ring"))
    else:
        params = replicate(_params(model, dev, generator), rows)
    lead = (rows, b)
    if dev.type == "meta":
        data = {k: torch.empty(lead + (s,), dtype=torch.int32, device=dev)
                for k in ("tokens", "labels")}
        if model.has_memory_input:
            data["memory"] = torch.empty(
                lead + (model.memory_tokens or 16,
                        model.memory_dim or model.d_model), device=dev)
    else:
        corpus = SyntheticLM(vocab_size=model.vocab_size, num_nodes=n)
        host = lm_batches_for_dfl(corpus, 1, n, b, s, 0)
        host = {k: v[0, group.rank:group.rank + 1] if group is not None
                else v[0] for k, v in host.items()}
        if model.has_memory_input:
            host["memory"] = _memory(
                model, (n, b) if mesh is not None else lead, 0)
        data = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        if mesh is not None:
            data = _mesh_batch(data, mesh, arch.sharding_mode, 0)
    loss_fn = _loss(model)
    grad_fn = vmap(grad_and_value(loss_fn))

    def local_step(params, opt_state, batch):
        if sub is None:
            grads, losses = grad_fn(params, batch)
        else:
            grads, losses = sub.node_grads(grad_fn, params, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
        return params, opt_state, torch.mean(losses)

    return Built(local_step, (params, opt.init(params), data), {
        "kind": "local", "arch": arch.arch_id, "shape": shape_name,
        "model": model.name, "nodes": n, "rows": rows, "batch": b,
        "seq": s, "device": str(dev),
        "mode": arch.sharding_mode if mesh is not None else None},
        substrate=sub)


def build_gossip_step(arch: ArchConfig, nodes: Nodes = 1, *,
                      topology: str = "ring",
                      compression: Optional[Compressor] = None,
                      reduced: bool = False,
                      cfg: Optional[ModelConfig] = None, device="cuda",
                      generator: Optional[torch.Generator] = None) -> Built:
    """ONE gossip step over the stacked parameters (plain: ``fn(params)``),
    or one CHOCO-G iteration (``fn(params, hat)``), through the round's own
    ``gossip_phase`` on the dense substrate, the group's sharded one or
    the mesh's (this rank's blocks of all N nodes in gossip-fsdp on one
    pod, of its node where the mesh has node axes)."""
    model = _model(arch, reduced, cfg)
    n, group = _split(nodes, arch)
    dev = group.device if group is not None else resolve_device(device)
    dcfg = DFLConfig(tau1=1, tau2=1, topology=_topology(n, topology),
                     compression=compression)
    rows = n
    if isinstance(nodes, Mesh):
        params, sub = _mesh_parts(arch, model, nodes, n, dev, generator,
                                  None, dcfg.topology)
        rows = 1 if _node_a_rank(arch, nodes) else n
    elif group is not None:
        sub = ShardedSubstrate(dcfg.topology, group)
        rows = 1
    else:
        sub = DenseSubstrate(dcfg.topology)
    if not isinstance(nodes, Mesh):
        params = replicate(_params(model, dev, generator), rows)

    if compression is None:
        def gossip_step(params):
            return gossip_phase(dcfg, sub, params, None)[0]
        args = (params,)
    else:
        draws = GeneratorDraws(1, n, params.keys(), dev)

        def gossip_step(params, hat):
            return gossip_phase(dcfg, sub, params, hat, draws)
        args = (params, {k: torch.zeros_like(v) for k, v in params.items()})
    return Built(gossip_step, args, {
        "kind": "gossip", "arch": arch.arch_id, "model": model.name,
        "nodes": n, "rows": rows, "topology": dcfg.topology.name,
        "compressed": compression is not None, "device": str(dev)},
        substrate=sub)


def roofline_cost_inputs(arch: ArchConfig, shape_name: str,
                         nodes: Nodes = 1, *, topology: str = "ring",
                         reduced: bool = False,
                         cfg: Optional[ModelConfig] = None,
                         batch: Optional[int] = None,
                         seq: Optional[int] = None,
                         device="cuda") -> Dict[str, float]:
    """MEASURED planner cost inputs, the reference's keys and contract.

    ``step_flops``: ONE node's local step, counted by
    ``roofline.analyze_step`` over ``build_local_step`` on ``meta`` tensors
    (so nothing is allocated, and the count is the same on any host) and
    divided by the device's node count: the ``ComputeModel.step_flops``
    contract. ``step_hbm_bytes``: the device's local step's eager operand
    and result bytes (``roofline.ByteCounter``). ``gossip_collective_bytes``:
    the bytes one device sends in one gossip step. On the dense engine one
    device holds every node and nothing crosses a process: 0.0, and
    ``plan_train_schedule`` then falls back to the analytic wire size, as
    the reference does on a one-device host mesh. On a ``NodeGroup`` or a
    ``Mesh`` one gossip step runs on ``device`` (the group's own device on
    a ``NodeGroup``; every rank must call this) and the group's
    ``exchange_bytes`` counter reads what this rank packed and sent (0 on
    a single-pod gossip-fsdp mesh, whose nodes are all on every rank). On
    a mesh the local step is counted as N stacked nodes (``nodes=N``): a
    rank of a mesh with node axes steps one of them, a single-pod
    gossip-fsdp rank all N."""
    mesh = nodes if isinstance(nodes, Mesh) else None
    n, group = _split(nodes, arch)
    local = build_local_step(arch, shape_name, n if mesh else nodes,
                             reduced=reduced, cfg=cfg, batch=batch, seq=seq,
                             device="meta")
    la = roof_lib.analyze_step(local.fn, *local.args)
    rank_rows = 1 if _node_a_rank(arch, mesh) else local.meta["rows"]
    sent = 0.0
    if group is not None or mesh is not None:
        gossip = build_gossip_step(arch, nodes, topology=topology,
                                   reduced=reduced, cfg=cfg, device=device)
        counter = gossip.substrate.group
        before = counter.exchange_bytes
        gossip.run()
        sent = float(counter.exchange_bytes - before)
    return {
        "step_flops": la["flops"] / local.meta["rows"],
        "step_hbm_bytes": la["bytes"] * rank_rows / local.meta["rows"],
        "gossip_collective_bytes": sent,
        "nodes": n,
    }


# ---------------------------------------------------------------------------
# The planned round
# ---------------------------------------------------------------------------


def plan_train_schedule(
    arch: ArchConfig,
    shape_name: str,
    nodes: Nodes = 1,
    *,
    budget_s: float,
    topology: str = "ring",
    compression: Optional[Compressor] = None,
    flops_per_s: Optional[float] = None,
    link_bytes_per_s: Optional[float] = None,
    sigma: float = 1.0,
    f_gap: float = 1.0,
    reduced: bool = False,
    grid=None,
    wire_engine: str = "auto",
    use_roofline: bool = False,
    cfg: Optional[ModelConfig] = None,
    batch: Optional[int] = None,
    seq: Optional[int] = None,
    device="cuda",
):
    """Pick (tau1, tau2) for an (arch, shape, nodes) deployment with the
    planner (``repro_torch.planner``) before building anything.

    By default the compute side is priced analytically, 6 * params *
    tokens FLOPs a local step a node at the card's bf16 peak
    (``roofline.PEAK_FLOPS_BF16``), and the gossip side from the model's
    fp32 wire size over one NVLink direction
    (``roofline.NVLINK_BYTES_PER_S``). With ``use_roofline=True`` both sides
    come from ``roofline_cost_inputs`` instead: the local step's counted
    FLOPs a node, and the gossip step's exchanged bytes folded back into an
    effective per-copy wire size (falling back to the analytic size when
    nothing was exchanged, the dense engine, or when a ``compression`` is
    set, since the planner derives the compressor's model_dim from
    model_bits). Returns the planner's ``Plan``; ``build_planned_round``
    turns it into a round."""
    from repro_torch.planner import (Budget, ComputeModel, CostModel,
                                     LinkModel, plan)

    model = _model(arch, reduced, cfg)
    shape = SHAPES[shape_name]
    n, _ = _split(nodes, arch)
    topo = _topology(n, topology)
    params = model.param_count()
    if batch is None:
        tokens_per_node = (shape.global_batch * (seq or shape.seq_len)
                           / max(n, 1))
    else:
        tokens_per_node = float(batch * (seq or shape.seq_len))
    step_flops = 6.0 * params * tokens_per_node
    model_bits = 32.0 * params
    if use_roofline:
        measured = roofline_cost_inputs(arch, shape_name, nodes,
                                        topology=topology, reduced=reduced,
                                        cfg=cfg, batch=batch, seq=seq,
                                        device=device)
        step_flops = measured["step_flops"]
        copies = mixing_lib.gossip_copies_per_step(topo, wire_engine)
        if (measured["gossip_collective_bytes"] > 0.0 and copies > 0
                and compression is None):
            # what one gossip step really sends, spread over the engine's
            # copy count, so round_cost's copies * model_bits reproduces it
            model_bits = (8.0 * measured["gossip_collective_bytes"]
                          / copies)
    cost_model = CostModel(
        compute=ComputeModel(
            step_flops=step_flops,
            flops_per_s=flops_per_s or roof_lib.PEAK_FLOPS_BF16),
        link=LinkModel(
            bytes_per_s=link_bytes_per_s or roof_lib.NVLINK_BYTES_PER_S),
        topology=topo,
        model_bits=model_bits,
        engine=wire_engine)
    kw = dict(sigma=sigma, f_gap=f_gap)
    if grid is not None:
        kw["grid"] = grid
    if compression is not None:
        kw["compressors"] = (compression,)
    return plan(Budget(wall_clock_s=budget_s), cost_model, **kw)


def build_train_round(
    arch: ArchConfig,
    shape_name: str,
    nodes: Nodes = 1,
    *,
    tau1: int = 4,
    tau2: int = 4,
    compression: Optional[Compressor] = None,
    mixing_impl: str = "dense",
    topology: str = "ring",
    lr: float = 1e-3,
    reduced: bool = False,
    rounds: int = 1,
    cfg: Optional[ModelConfig] = None,
    batch: Optional[int] = None,
    seq: Optional[int] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    node_chunk: Optional[int] = None,
) -> Built:
    """DFL rounds at (tau1, tau2) on a ``RoundExecutor``, as the train CLI
    runs them: ``fn(state, batches) -> (state', metrics)`` dispatches the
    ``rounds`` rounds of ``batches`` (``[rounds, tau1, N, B, S]`` tokens of
    the synthetic corpus, ``data.lm``) as one superstep, the state kept in
    place. Every node starts from one model (``generator``, default a CPU
    generator seeded 0), SGD at ``lr``, the seam drawing from seed 1. On
    the card the executor replays CUDA graphs captured in ``warmup()``.
    On a mesh the executor runs eager rounds over the mesh's substrate:
    in gossip-fsdp on one pod the state is this rank's blocks of all N
    nodes and the batches its part of each node's (``MeshSubstrate``,
    whose local step gathers the weights ``node_chunk`` nodes at a time,
    all N by default); where the mesh has node axes (gossip-dp, gossip-fsdp
    on pods) its block of its node and its part of that node's batches
    (``NodeMeshSubstrate``; ``node_chunk`` raises). ``meta["engine"]`` is
    ``select_engine``'s choice for the mesh, the reference's: "sparse" on
    a data N x model 1 mesh with a circulant C, whose round the gossip-dp
    substrate runs as the sparse engine does, else "dense"."""
    mesh = nodes if isinstance(nodes, Mesh) else None
    if node_chunk is not None and mesh is None:
        raise ValueError("node_chunk= sets a mesh's local step; nodes= "
                         "is not a mesh")
    model = _model(arch, reduced, cfg)
    n, group = _split(nodes, arch)
    b, s = _batch_shape(arch, shape_name, n, batch, seq)
    dev = group.device if group is not None else resolve_device(device)
    dcfg = DFLConfig(tau1=tau1, tau2=tau2, topology=_topology(n, topology),
                     mixing_impl=mixing_impl, compression=compression)
    opt = sgd(lr)
    sub = None
    if mesh is not None:
        params0, sub = _mesh_parts(arch, model, mesh, n, dev, generator,
                                   node_chunk, dcfg.topology)
        stacked = True
    else:
        params0 = _params(model, dev, generator)
        stacked = False
    state = init_state(params0, 1 if group is not None else n, opt,
                       stacked=stacked, compressed=compression is not None,
                       seed=1, draws=GeneratorDraws(1, n, params0.keys(), dev))
    del params0
    corpus = SyntheticLM(vocab_size=model.vocab_size, num_nodes=n)
    host = []
    for r in range(rounds):
        one = dict(lm_batches_for_dfl(corpus, tau1, n, b, s, r))
        if model.has_memory_input:
            one["memory"] = _memory(model, (tau1, n, b), r)
        host.append(one)
    batches = stack_round_batches(host, tau1, dev)
    if group is not None:
        batches = local_rows(batches, group, axis=2)
    if mesh is not None:
        batches = _mesh_batch(batches, mesh, arch.sharding_mode, 2)
    engine = "sparse" if group is not None else "dense"
    executor = RoundExecutor(dcfg, _loss(model), opt, engine=engine,
                             dynamic=mixing_impl != "dense_power",
                             group=group, substrate=sub)
    if mesh is not None:
        engine = select_engine("auto", dcfg, mesh, arch.sharding_mode)

    def round_fn(state, batches):
        return executor.dispatch(state, batches, tau1, tau2)

    return Built(round_fn, (state, batches), {
        "kind": "round", "arch": arch.arch_id, "shape": shape_name,
        "model": model.name, "nodes": n, "tau1": tau1, "tau2": tau2,
        "rounds": rounds, "batch": b, "seq": s, "mixing": mixing_impl,
        "engine": engine, "compressed": compression is not None,
        "device": str(dev),
        "mode": arch.sharding_mode if mesh is not None else None},
        executor=executor, substrate=sub)


def build_planned_round(
    arch: ArchConfig,
    shape_name: str,
    nodes: Nodes = 1,
    *,
    budget_s: float,
    topology: str = "ring",
    compression: Optional[Compressor] = None,
    reduced: bool = False,
    cfg: Optional[ModelConfig] = None,
    batch: Optional[int] = None,
    seq: Optional[int] = None,
    rounds: int = 1,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    **plan_kw,
) -> Built:
    """``build_train_round`` with (tau1, tau2) chosen by the planner; the
    chosen Plan's knobs and prediction land in ``meta["plan"]``, under the
    reference's keys."""
    p = plan_train_schedule(
        arch, shape_name, nodes, budget_s=budget_s, topology=topology,
        compression=compression, reduced=reduced, cfg=cfg, batch=batch,
        seq=seq, device=device, **plan_kw)
    built = build_train_round(
        arch, shape_name, nodes, tau1=p.tau1, tau2=p.tau2,
        compression=p.compressor, topology=topology, reduced=reduced,
        rounds=rounds, cfg=cfg, batch=batch, seq=seq, device=device,
        generator=generator)
    built.meta["plan"] = {
        "tau1": p.tau1, "tau2": p.tau2, "eta": p.eta,
        "compressor": p.compressor_name, "rounds": p.rounds,
        "predicted_bound": p.predicted_bound,
        "round_time_s": p.round_cost.time_s,
        "round_wire_bits": p.round_cost.wire_bits,
        "budget_s": budget_s,
        "use_roofline": bool(plan_kw.get("use_roofline", False)),
    }
    return built
