"""The node substrate: the node axis the shared DFL round runs over.

``repro_torch.core.dfl`` writes the round once against ``NodeSubstrate``;
``DenseSubstrate`` holds all N nodes stacked on a leading ``[N, ...]`` axis
of every leaf, which is how one card holds them. Its hooks reach the
kernels:

  * ``mix``        — one gossip step X <- X C: the gossip kernel (K1), one
                     call for the leaves of each dtype, when C is
                     circulant, else the dense product ``mix_dense``. An
                     edge mask folds each masked edge's weight onto its
                     endpoints' self loops: on a circulant C through the
                     round's per-node weight table (K1 unchanged), else
                     through ``mix_dense(edge_mask=)``.
  * ``choco_step`` — one CHOCO-G iteration after the mix:
                     TopK: every leaf's gap in the leaf dtype, their
                     per-node thresholds in one call (K4) for the leaves
                     of each dtype, then the fused move-and-update (K3)
                     per leaf;
                     QSGD: the gap's per-node f32 norm, the noise from the
                     RNG seam and the fused move-and-quantize (K2);
                     any other compressor: the move (K7), ``compress``
                     on the gaps, and ``y + q``.
  * ``compress``   — Q on every node's slice of each leaf of a tree
                     whose leading axis is the node axis, with its draws
                     from the seam: QSGD every leaf's per-node norm and one
                     K6 call for the leaves of each dtype, any other
                     compressor leaf by leaf.

Participation (sporadic rounds): ``select_nodes`` keeps a masked node's
old state, ``masked_mean_over_nodes`` averages over active nodes. Masks
are host arrays (rows of the executor's trajectory); each distinct mask
goes to the device once, without blocking the host.

``BatchedSubstrate`` runs the same round over a sampled cohort of a
virtual population stacked ``[V, ...]``: it gathers the cohort's rows,
hands the seam the cohort's global ids, and writes the rows back in place.

``ShardedSubstrate`` is the sparse engine's: one node per process, every
leaf that node's ``[1, ...]`` row; ``mix`` exchanges the leaves over each
shift of a circulant C (``core.sharded.NodeGroup``) and mixes the copies
received with K1's received-buffer form; ``choco_step`` and ``compress``
are the dense ones above (``NodeSubstrate``), on one row; the means over
nodes are sums over the ranks.

``MeshSubstrate`` is the gossip-fsdp mesh's: every rank holds all N
nodes, each leaf cut into blocks over the ranks of a mesh
(``launch.sharding``); the dense hooks run on the blocks, what spans a
whole row is reduced over the ranks that hold it, and the local step
gathers the weights and reduces the gradients back to the blocks
(``node_grads``, the round's seam between parameters and gradients).

``NodeMeshSubstrate`` is gossip-dp's on such a mesh: a node a ``data``
coordinate, its leaves split over ``model``; the sparse engine's hooks on
the rank's block of its node, the shift exchange along ``data``, and the
gossip-fsdp mesh's row operations over ``model``.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mixing as mixing_lib
from repro_torch.core.compression import (QSGD, WHOLE_ROWS, Compressor,
                                          RowOps, TopK, by_dtype)
from repro_torch.core.sharded import (DATA_AXIS, block_spans, entry_axes,
                                      spec_axes)
from repro_torch.core.topology import Topology
from repro_torch.core.tree import leaf_order, tree_leaves, tree_map
from repro_torch.device import to_device
from repro_torch.kernels import ops
from repro_torch.kernels.choco_fused import gap

Params = Dict[str, torch.Tensor]

__all__ = ["NodeSubstrate", "DenseSubstrate", "BatchedSubstrate",
           "ShardedSubstrate", "MeshSubstrate", "NodeMeshSubstrate"]


class _DeviceCache:
    """Host arrays on a device, each distinct (content, device) copied
    once without blocking the host; a bounded FIFO."""

    MAX = 128

    def __init__(self):
        self._entries: Dict[Any, torch.Tensor] = {}

    def get(self, key, device, build: Callable[[], np.ndarray]):
        key = (key, device)
        hit = self._entries.get(key)
        if hit is None:
            if len(self._entries) >= self.MAX:
                self._entries.pop(next(iter(self._entries)))
            hit = to_device(torch.from_numpy(np.ascontiguousarray(build())),
                            device)
            self._entries[key] = hit
        return hit


def _host_mask(mask) -> np.ndarray:
    """A 0/1 participation mask as a host int32 array (device tensors are
    refused: reading one would wait for the device)."""
    if torch.is_tensor(mask) and mask.device.type != "cpu":
        raise TypeError("participation masks are host data: pass numpy "
                        "arrays or CPU tensors")
    return np.asarray(mask, dtype=np.int32).reshape(-1)


class NodeSubstrate:
    """The node-axis contract (N = number of nodes):

      * ``mix(tree, edge_mask=None)`` — one uncompressed gossip step
                                  X <- X C; ``edge_mask`` ([E] 0/1 over
                                  ``topology.edges()``) drops masked edges
                                  and returns their weight to the self
                                  loops (bitwise the plain step at all
                                  ones).
      * ``mean_over_nodes(x)``   — mean over nodes of per-node values.
      * ``sum_per_node(x)``      — sum an array down to one value per node.
      * ``mean_tree(tree)``      — per-leaf f32 mean over nodes.
      * ``compress(...)``        — Q on every node's slice of a tree.
      * ``choco_step(...)``      — one CHOCO-G iteration after the mix.

    Participation hooks:
      * ``node_mask_local(node_mask)``  — the round's [N] node mask in this
        substrate's view (dense: the host vector itself).
      * ``select_nodes(mask, new, old)`` — per node, ``new`` where the
        mask is one and ``old`` where it is zero, over any tree of
        ``[N, ...]`` leaves; ``new`` itself at all ones.
      * ``masked_mean_over_nodes(x, mask)`` — mean of per-node values
        over active nodes; bitwise ``mean_over_nodes`` at all ones.

    ``node_ids``: the ids the RNG seam draws for, one per node held (None:
    every node of the seam, in order). ``rows``: the node rows every leaf
    holds (the leading dimension): all N stacked, or one node's.
    """

    num_nodes: int
    node_ids: Optional[np.ndarray] = None

    @property
    def rows(self) -> int:
        return self.num_nodes

    def mix(self, tree: Params, edge_mask=None) -> Params:
        raise NotImplementedError

    def mean_over_nodes(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sum_per_node(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mean_tree(self, tree: Params) -> Params:
        raise NotImplementedError

    def node_mask_local(self, node_mask) -> np.ndarray:
        raise NotImplementedError

    def select_nodes(self, mask_local, new: Any, old: Any) -> Any:
        raise NotImplementedError

    def masked_mean_over_nodes(self, x: torch.Tensor,
                               mask_local) -> torch.Tensor:
        raise NotImplementedError

    def row_ops(self, names) -> RowOps:
        """How a compressor reads the whole rows of the leaves ``names``
        (``compression.RowOps``): here every row is whole in its tensor."""
        return WHOLE_ROWS

    def draw_leaves(self, comp: Compressor, draws, round_idx: int, step: int,
                    tree: Params) -> list:
        """``comp``'s draws for every leaf of ``tree`` (its rows flat), for
        the nodes ``node_ids``, in one ``draw_many`` call on the seam."""
        names = list(tree)
        return comp.draw_many(draws, round_idx, step, names,
                              [tree[name][0].numel() for name in names],
                              self.node_ids)

    def node_grads(self, grad_fn: Callable, params: Params, batch: Any):
        """The local step's ``(grads, per-node loss)``: ``grad_fn``
        (``vmap(grad_and_value(loss))``) on the nodes' parameters and one
        step's batch. Here the parameters are whole, so it is that call;
        a substrate that holds blocks gathers first and reduces after
        (``MeshSubstrate``)."""
        return grad_fn(params, batch)

    def compress(self, comp: Compressor, tree: Params, draws=None,
                 round_idx: int = 0, step: int = 0) -> Params:
        """Q on every node's slice of each leaf of ``tree``, whose leading
        axis is the node axis (the nodes this substrate holds), each leaf
        with its draws for gossip step ``step`` of round ``round_idx`` from
        the seam ``draws``, for the nodes ``node_ids``: one
        ``per_node_many`` call for the tree, which makes one K4 and one K5
        call per dtype under TopK, one K6 call per dtype under QSGD, and
        goes leaf by leaf for the other compressors."""
        names = list(tree)
        us = self.draw_leaves(comp, draws, round_idx, step, tree)
        return dict(zip(names, comp.per_node_many(
            [tree[name] for name in names], us, self.row_ops(names))))

    def choco_step(self, comp: Compressor, x: Params, y: Params,
                   mixed_y: Params, gamma: float, draws=None,
                   round_idx: int = 0, step: int = 0
                   ) -> Tuple[Params, Params]:
        """Consensus move x += gamma (C y - y), compress the gap per node,
        update the estimates y += Q(x_new - y) (Alg. 2 l.6-7, 11) with the
        draws for gossip step ``step`` of round ``round_idx`` from the seam
        ``draws``; returns (x_new, y_new). TopK and QSGD run fused, emitting
        (x_new, y_new) in one pass per leaf. TopK: every leaf's gap d in the
        leaf dtype, the thresholds of the leaves of each dtype in one K4
        call, then K3 per leaf. QSGD, per leaf: d's per-node f32 norm and
        K2 (which recomputes d bitwise). Other compressors: the unfused
        composition (``choco_unfused``). Whole-row quantities (k, c, the
        thresholds and norms) come from ``row_ops``."""
        if not isinstance(comp, (TopK, QSGD)):
            return self.choco_unfused(comp, x, y, mixed_y, gamma, draws,
                                      round_idx, step)
        n = self.rows
        rows = {name: tuple(t[name].reshape(n, -1) for t in (x, y, mixed_y))
                for name in x}
        row_ops = self.row_ops(list(rows))
        x_new, y_new = {}, {}
        if isinstance(comp, TopK):
            gaps = [gap(a, b, my, gamma) for a, b, my in rows.values()]
            threshs = row_ops.thresholds(
                gaps, [comp._k(d) for d in row_ops.lengths(gaps)])
            for i, ((name, (a, b, my)), t) in enumerate(zip(rows.items(),
                                                            threshs)):
                x_new[name], y_new[name] = ops.choco_topk(a, b, my, gaps[i],
                                                          t, gamma)
                gaps[i] = None     # each gap freed once its leaf is done
        else:
            lengths = row_ops.lengths([r[0] for r in rows.values()])
            noises = self.gap_noises(comp, draws, round_idx, step, x)
            for i, ((name, (a, b, my)), noise, length) in enumerate(zip(
                    rows.items(), noises, lengths)):
                d = gap(a, b, my, gamma)
                (norm,) = row_ops.part([i]).norms([d])
                x_new[name], y_new[name] = ops.choco_qsgd(
                    a, b, my, noise, norm, gamma, comp.levels,
                    comp._c(length))
        return ({name: v.reshape(x[name].shape) for name, v in x_new.items()},
                {name: v.reshape(x[name].shape) for name, v in y_new.items()})

    def gap_noises(self, comp: Compressor, draws, round_idx: int, step: int,
                   x: Params):
        """QSGD's noise for the gaps of every leaf of ``x``, in its order:
        here one ``draw_leaves`` call for the step."""
        return self.draw_leaves(comp, draws, round_idx, step, x)

    def choco_unfused(self, comp: Compressor, x: Params, y: Params,
                      mixed_y: Params, gamma: float, draws=None,
                      round_idx: int = 0, step: int = 0
                      ) -> Tuple[Params, Params]:
        """The unfused CHOCO-G composition: the move and the gap in one
        pass (K7) per leaf, then ``compress`` on every gap with the draws
        for gossip step ``step`` of round ``round_idx`` from the seam
        ``draws``, then the add; returns (x_new, y_new)."""
        n = self.rows
        x_new, gaps = {}, {}
        for name in x:
            a, b, my = (t[name].reshape(n, -1) for t in (x, y, mixed_y))
            x_new[name], gaps[name] = ops.choco_move(a, b, my, gamma)
        q = self.compress(comp, gaps, draws, round_idx, step)
        return ({name: v.reshape(x[name].shape) for name, v in x_new.items()},
                {name: (y[name].reshape(n, -1) + q[name]).reshape(
                    x[name].shape) for name in x})

    def consensus_sq(self, params: Params) -> torch.Tensor:
        """||X (I - J)||_F^2 / N (Lemma 1's drift), in f32, the per-node
        sums added leaf by leaf in the reference's leaf order
        (``tree.leaf_order``), whatever the dict's order."""
        mean = self.mean_tree(params)
        dev = None
        for name in leaf_order(params):
            d = (params[name].float() - mean[name].float()) ** 2
            per_node = self.sum_per_node(d)
            dev = per_node if dev is None else dev + per_node
        return self.mean_over_nodes(dev)


class DenseSubstrate(NodeSubstrate):
    """Stacked node axis: every leaf [N, ...]; any topology."""

    def __init__(self, topology: Topology):
        self.topology = topology
        self.num_nodes = topology.num_nodes
        self._table = (mixing_lib.gossip_table(topology)
                       if topology.is_shift_structured() else None)
        self._on_device = _DeviceCache()

    def _table_on(self, device, edge_mask: Optional[np.ndarray]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The gossip table on ``device``, its weights those of the round's
        edge mask (``masked_gossip_weights``); each distinct one is copied
        there once without blocking the host."""
        nbr = self._on_device.get("nbr", device, lambda: self._table[0])
        if edge_mask is None:
            return nbr, self._on_device.get("w", device,
                                            lambda: self._table[1])
        return nbr, self._on_device.get(
            ("w", edge_mask.tobytes()), device,
            lambda: mixing_lib.masked_gossip_weights(self.topology,
                                                     edge_mask))

    def host_edge_mask(self, edge_mask) -> Optional[np.ndarray]:
        """The round's edge mask as a host array, None at all ones (every
        term of the masked weights is exact there)."""
        mask = None if edge_mask is None else _host_mask(edge_mask)
        if mask is not None and mask.shape != (self.topology.num_edges,):
            raise ValueError(f"edge mask has {mask.size} entries, the "
                             f"topology {self.topology.num_edges} edges")
        return None if mask is not None and mask.all() else mask

    def mix_operand(self, device, edge_mask=None, dtypes=(torch.float32,),
                    topology: Optional[Topology] = None
                    ) -> Dict[Any, torch.Tensor]:
        """What one gossip step reads besides the tree (``mix_by``), on
        ``device``: on a circulant C, ``{"nbr": K1's neighbour table, "w":
        its weights with the round's edge mask}``; else the confusion
        matrix, masked, in every dtype the leaves of ``dtypes`` promote to
        with f32 (``{dtype: C}``, ``mix_dense``'s). ``topology``: another
        graph than the substrate's, always mixed by the dense product (a
        round of a topology schedule); no mask then."""
        mask = None if topology is not None else self.host_edge_mask(edge_mask)
        if topology is None and self._table is not None:
            nbr, w = self._table_on(device, mask)
            return {"nbr": nbr, "w": w}
        topo = self.topology if topology is None else topology
        dev_mask = None if mask is None else self._on_device.get(
            ("edge_mask", mask.tobytes()), device, lambda: mask)
        out = {}
        for dt in {torch.promote_types(d, torch.float32) for d in dtypes}:
            out[dt] = (self._on_device.get(
                ("C", topo.mixing.tobytes(), str(dt)), device,
                # repro-lint: disable=no-host-coercion-of-device-scalars (a host tensor cast on the host)
                lambda: torch.from_numpy(topo.mixing).to(dt).numpy())
                if dev_mask is None else mixing_lib.masked_mixing_matrix(
                    topo, dev_mask, dt))
        return out

    def mix_by(self, tree, operand: Dict[Any, torch.Tensor]):
        """One gossip step of ``tree`` with ``operand`` (``mix_operand``):
        K1 for the leaves of each dtype under a gossip table, else the dense
        product with the matrix of each leaf's promoted dtype."""
        if not tree:
            return {}
        names = list(tree)
        if "w" not in operand:
            return {name: mixing_lib.contract(
                operand[torch.promote_types(x.dtype, torch.float32)], x)
                for name, x in tree.items()}
        nbr, w = operand["nbr"], operand["w"]
        mixed = by_dtype(
            [tree[name].reshape(self.num_nodes, -1) for name in names],
            lambda xs: ops.gossip_mix_many(xs, nbr, w))
        return {name: m.reshape(tree[name].shape)
                for name, m in zip(names, mixed)}

    def mix(self, tree, edge_mask=None):
        if not tree:
            return {}
        device = next(iter(tree.values())).device
        return self.mix_by(tree, self.mix_operand(
            device, edge_mask, {x.dtype for x in tree.values()}))

    def mean_over_nodes(self, x):
        return x.mean(dim=0)

    def sum_per_node(self, x):
        return x.reshape(x.shape[0], -1).sum(dim=1)

    def mean_tree(self, tree):
        return {name: x.float().mean(dim=0) for name, x in tree.items()}

    def node_mask_local(self, node_mask):
        mask = _host_mask(node_mask)
        if mask.shape != (self.num_nodes,):
            raise ValueError(f"node mask has {mask.size} entries for "
                             f"{self.num_nodes} nodes")
        return mask

    def _mask_on(self, mask: np.ndarray, device, kind: str) -> torch.Tensor:
        return self._on_device.get(
            (kind, mask.tobytes()), device,
            lambda: mask.astype(bool if kind == "bool" else np.float32))

    def node_mask_on(self, mask_local, device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
        """The host node mask on ``device`` as (bool, f32) ``[N]`` tensors,
        what ``select_by`` and ``masked_mean_by`` read."""
        mask = np.asarray(mask_local)
        return (self._mask_on(mask, device, "bool"),
                self._mask_on(mask, device, "float"))

    def select_nodes(self, mask_local, new, old):
        mask = np.asarray(mask_local)
        if mask.all():
            return new
        device = tree_leaves(new)[0].device
        return self.select_by(self._mask_on(mask, device, "bool"), new, old)

    @staticmethod
    def select_by(mask: torch.Tensor, new, old):
        """Per node, ``new`` where the device bool mask ``[N]`` is set and
        ``old`` elsewhere, over trees of ``[N, ...]`` leaves."""
        return tree_map(lambda nw, od: torch.where(
            mask.reshape((-1,) + (1,) * (nw.dim() - 1)), nw, od), new, old)

    def masked_mean_over_nodes(self, x, mask_local):
        return self.masked_mean_by(
            x, self._mask_on(np.asarray(mask_local), x.device, "float"))

    def masked_mean_by(self, x, m: torch.Tensor):
        """mean(x m) / max(mean(m), 1/N) with the device f32 mask ``m``:
        an exact ``/ 1.0`` at all ones, and 0 (not NaN) when every node is
        masked."""
        num = self.mean_over_nodes(x * m)
        return num / self.mean_over_nodes(m).clamp(
            min=1.0 / max(self.num_nodes, 1))


class BatchedSubstrate(DenseSubstrate):
    """The dense substrate over a sampled cohort of a virtual population.

    Training state stays stacked ``[population, ...]``; each round gathers
    the rows of ``cohort_ids`` (``[C]`` global node ids, host ints, C the
    cohort ``topology``'s node count), runs the ordinary dense round over
    the cohort and writes the rows back in place (``index_copy_`` into the
    state's own tensors), so rows outside the cohort are bitwise untouched
    and no ``[population, ...]`` tree is built. The seam draws by global
    id (``node_ids``), so a virtual node's draws follow its identity, not
    its slot. ``cohort_ids=None`` is the identity cohort ``arange(C)``; at
    ``population == C`` the identity cohort gathers and scatters nothing,
    and the round is bitwise the dense round.
    """

    def __init__(self, topology: Topology, population: int,
                 cohort_ids=None):
        super().__init__(topology)
        population = int(population)
        if population < topology.num_nodes:
            raise ValueError(f"population {population} smaller than the "
                             f"cohort topology's {topology.num_nodes} nodes")
        self.population = population
        self._set_ids(cohort_ids)

    def _set_ids(self, cohort_ids) -> None:
        c = self.num_nodes
        ids = (np.arange(c, dtype=np.int64) if cohort_ids is None
               else np.asarray(cohort_ids, dtype=np.int64).reshape(-1))
        if ids.shape != (c,):
            raise ValueError(f"{ids.size} cohort ids for a {c}-node cohort")
        if c and (ids.min() < 0 or ids.max() >= self.population):
            raise ValueError(f"cohort ids must lie in [0, {self.population})")
        if len(np.unique(ids)) != c:
            raise ValueError("cohort ids must be unique")
        self.node_ids = ids
        self._ids_dev: Dict[Any, torch.Tensor] = {}
        self._identity = (c == self.population
                          and bool((ids == np.arange(c)).all()))

    def with_cohort(self, cohort_ids) -> "BatchedSubstrate":
        """This substrate over another cohort; the device copies of the
        gossip tables and masks are shared."""
        out = copy.copy(self)
        out._set_ids(cohort_ids)
        return out

    def _ids_on(self, device) -> torch.Tensor:
        if device not in self._ids_dev:
            self._ids_dev[device] = to_device(
                torch.from_numpy(self.node_ids), device)
        return self._ids_dev[device]

    def gather_cohort(self, tree: Any) -> Any:
        """The cohort's rows of a ``[population, ...]`` tree (the tree
        itself for the identity cohort at full population)."""
        if tree is None or self._identity:
            return tree
        return tree_map(lambda x: x.index_select(0, self._ids_on(x.device)),
                        tree)

    def scatter_cohort(self, full: Any, cohort: Any) -> Any:
        """Write the cohort's rows into ``full``'s own tensors (in place;
        every other row untouched) and return ``full``; the identity
        cohort at full population returns ``cohort``."""
        if full is None or self._identity:
            return cohort
        return tree_map(
            lambda f, c: f.index_copy_(0, self._ids_on(f.device), c),
            full, cohort)


class ShardedSubstrate(NodeSubstrate):
    """One node per process: every leaf is this rank's ``[1, ...]`` row of
    the stacked state, and the ranks of ``group`` (``core.sharded.
    NodeGroup``, rank i holding node i) enumerate the nodes. Needs a
    circulant C (``topology.is_shift_structured()``); a gossip step sends
    this node's leaves to its neighbour over every shift and mixes what it
    receives (``mixing.mix_shifts``, K1's received form), deg copies a
    step where the dense product reads all N.

    ``mix`` sums the received copies in the dense engine's order, node
    (i + s_k) mod N for the k-th shift of ``topology.shifts()``, with that
    shift's weight, so that a step is bitwise ``DenseSubstrate.mix``'s row
    i: in the reference's direction (node i receives from (i - s) mod N)
    term k is the exchange over shift (N - s_k) mod N, which a symmetric C
    gives the same weight. ``shift_edge_idx`` and ``shift_masks`` are the
    reference's, in the order of ``topology.shifts()``. ``choco_step`` and
    ``compress`` run the dense kernels (K2-K7) on the ``[1, D]`` rows, the
    seam drawing for this node's id (``node_ids``); the means over nodes
    are sums over the ranks (``group.all_reduce_sum``) divided by N.
    Masks are host arrays, the same on every rank. The caller checks
    ``topology`` and ``group`` first (``core.dfl.check_sparse``).
    """

    def __init__(self, topology: Topology, group):
        self.topology = topology
        self.group = group
        self.num_nodes = n = topology.num_nodes
        self.shifts = topology.shifts()
        self.self_weight = float(topology.self_weights[0]) if n else 1.0
        self.node_ids = np.asarray([self.node_index()], np.int64)
        # Per-shift edge lookup for participation masks: entry [k, i] is
        # the ``topology.edges()`` index of the edge node i receives over
        # on shift k (from node (i - s_k) mod N); both endpoints of an
        # undirected edge resolve to the same entry.
        if self.shifts and topology.num_edges:
            eix = topology.edge_index()
            self.shift_edge_idx = np.asarray(
                [[eix[tuple(sorted(((i - s) % n, i)))] for i in range(n)]
                 for (s, _) in self.shifts], dtype=np.int32)
        else:
            self.shift_edge_idx = np.zeros((0, n), np.int32)
        index = {s: k for k, (s, _) in enumerate(self.shifts)}
        # term k of the dense order: the exchange over shift -s_k, whose
        # received copy is node (i + s_k)'s, with the k-th shift's weight
        self._terms = [((-s) % n, w) for s, w in self.shifts]
        self._term_shift = [index[(-s) % n] for s, _ in self.shifts]

    @property
    def rows(self) -> int:
        return 1

    def node_index(self) -> int:
        return self.group.rank

    def shift_masks(self, edge_mask) -> Tuple[float, ...]:
        """This node's 0/1 value per shift of ``topology.shifts()``, from
        the round's [E] edge mask (host values)."""
        mask = _host_mask(edge_mask)
        if mask.shape != (self.topology.num_edges,):
            raise ValueError(f"edge mask has {mask.size} entries, the "
                             f"topology {self.topology.num_edges} edges")
        i = self.node_index()
        return tuple(float(mask[self.shift_edge_idx[k, i]])
                     for k in range(len(self.shifts)))

    def mix(self, tree, edge_mask=None):
        masks = None
        if edge_mask is not None:
            by_shift = self.shift_masks(edge_mask)
            if not all(by_shift):
                masks = [by_shift[k] for k in self._term_shift]
        return mixing_lib.mix_shifts(tree, self._terms, self.self_weight,
                                     self.group.shift_exchange, masks)

    def sum_over_nodes(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the nodes' ranks (``group.all_reduce_sum``)."""
        return self.group.all_reduce_sum(t)

    def mean_over_nodes(self, x):
        return (self.sum_over_nodes(x) / self.num_nodes)[0]

    def sum_per_node(self, x):
        return x.reshape(1, -1).sum(dim=1)

    def mean_tree(self, tree):
        """Every leaf's f32 mean over nodes, the leaves summed over the
        ranks in one call."""
        names = list(tree)
        flat = torch.cat([tree[name].float().reshape(-1) for name in names])
        total = self.sum_over_nodes(flat) / self.num_nodes
        out, at = {}, 0
        for name in names:
            shape = tree[name].shape[1:]
            size = tree[name][0].numel()
            out[name] = total[at:at + size].reshape(shape)
            at += size
        return out

    def node_mask_local(self, node_mask):
        mask = _host_mask(node_mask)
        if mask.shape != (self.num_nodes,):
            raise ValueError(f"node mask has {mask.size} entries for "
                             f"{self.num_nodes} nodes")
        return int(mask[self.node_index()])

    def select_nodes(self, mask_local, new, old):
        return new if mask_local else old

    def masked_mean_over_nodes(self, x, mask_local):
        """mean(x m) / max(mean(m), 1/N) over the ranks, m this node's 0/1
        value: 0 (not NaN) when every node is masked."""
        m = float(mask_local)
        both = self.sum_over_nodes(torch.stack(
            [(x * m).reshape(()), torch.full((), m, dtype=x.dtype,
                                             device=x.device)]))
        both = both / self.num_nodes
        return both[0] / both[1].clamp(min=1.0 / max(self.num_nodes, 1))


class _Blocks:
    """What a substrate whose leaves are blocks of the nodes' rows shares,
    the blocks cut over the ranks of a ``launch.mesh.Mesh`` by each leaf's
    spec (``specs``: the reference's ``spec_for_param`` with the node dim;
    ``shapes``: every leaf's whole ``[N, ...]`` shape): whole-row lengths,
    TopK's thresholds and QSGD's norms reduced over the ranks that hold a
    row's parts (``row_ops``, ``sum_rows``), draws at the block's global
    indices, QSGD's noise a leaf at a time (a block of the full-width
    tree's draws is gigabytes), and the consensus distance with each
    leaf's per-node sums added over its row's ranks. ``row_axes[name]``:
    the mesh axes a leaf's rows are split over (its spec past the node
    dim); ``blocks[name]``: its block of one node's row."""

    def _set_blocks(self, group, specs: Dict[str, tuple],
                    shapes: Dict[str, Tuple[int, ...]]) -> None:
        self.group = group
        mesh = group.mesh
        self.specs = {name: tuple(spec) for name, spec in specs.items()}
        self.shapes = {name: tuple(int(d) for d in shape)
                       for name, shape in shapes.items()}
        for name in self.specs:
            if self.shapes[name][0] != self.num_nodes:
                raise ValueError(f"leaf {name!r} stacks {self.shapes[name][0]}"
                                 f" nodes, the topology has {self.num_nodes}")
        self.row_axes = {name: spec_axes(spec[1:], mesh)
                         for name, spec in self.specs.items()}
        self.blocks = {name: (self.shapes[name][1:], block_spans(
            self.shapes[name][1:], self.specs[name][1:], mesh))
            for name in self.specs}
        self.lengths = {name: int(np.prod(shape[1:], dtype=np.int64))
                        for name, shape in self.shapes.items()}

    def row_ops(self, names) -> RowOps:
        return _MeshRows(self, list(names))

    def _gathered_step(self, grad_fn, params, batch, specs, batch_axes):
        """One local step of the nodes ``params`` holds this rank's blocks
        of (``specs``: their specs with the node dim whole): the whole
        weights gathered over the row axes, the vmapped gradient on this
        rank's part of the batch, and this rank's block of the gradients'
        mean over ``batch_axes``, the axes a node's batch is split over
        (``ShardGroup.reduce_to_shard``; none: the block of this rank's
        gradient); the loss is the mean over ``batch_axes``."""
        whole = self.group.gather(params, specs)
        g, loss = grad_fn(whole, batch)
        del whole
        return (self.group.reduce_to_shard(g, specs, batch_axes),
                self.group.mean_over(loss, batch_axes))

    def draw_leaves(self, comp, draws, round_idx, step, tree):
        names = list(tree)
        return comp.draw_many(draws, round_idx, step, names,
                              [self.lengths[name] for name in names],
                              self.node_ids,
                              blocks=[self.blocks[name] for name in names])

    def gap_noises(self, comp, draws, round_idx, step, x):
        """One leaf's noise at a time, each freed after its K2."""
        for name in x:
            yield self.draw_leaves(comp, draws, round_idx, step,
                                   {name: x[name]})[0]

    def sum_rows(self, values: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Each leaf's per-row values (f32 partial sums of this rank's
        block, one a node held) summed over the ranks of that leaf's row
        axes: one collective for the leaves of each set of axes, in the
        leaves' order."""
        out = {}
        by_axes: Dict[tuple, list] = {}
        for name in values:
            by_axes.setdefault(self.row_axes[name], []).append(name)
        for axes, names in by_axes.items():
            total = self.group.sum_over(
                torch.stack([values[name] for name in names]), axes)
            out.update(zip(names, total))
        return out

    def consensus_sq(self, params: Params) -> torch.Tensor:
        """``NodeSubstrate.consensus_sq`` with each leaf's per-node sums
        added over the ranks of its row (``sum_rows``), then the leaves in
        the reference's leaf order."""
        mean = self.mean_tree(params)
        sums = self.sum_rows({name: self.sum_per_node(
            (params[name].float() - mean[name].float()) ** 2)
            for name in leaf_order(params)})
        dev = None
        for name in leaf_order(params):
            dev = sums[name] if dev is None else dev + sums[name]
        return self.mean_over_nodes(dev)


class MeshSubstrate(_Blocks, DenseSubstrate):
    """The gossip-fsdp mesh: every rank holds all N nodes (node-replicated),
    each leaf the block of every node that its spec gives this rank's
    coordinates on a ``launch.mesh.Mesh`` (``specs``, ``shapes``: as
    ``_Blocks``; the node dim's entry must be None here: a node dim
    sharded over node axes, gossip-dp's placement or gossip-fsdp's on
    pods, is ``NodeMeshSubstrate``'s).
    ``group`` is the rank's ``core.sharded.ShardGroup``.

    The node axis is whole on every rank, so the dense hooks run on the
    blocks as they are: ``mix`` is ``DenseSubstrate.mix_by`` on the block
    tree (K1), and the means over nodes are local. What spans a whole row
    is reduced over the ranks that hold that row's distinct parts, the axes
    the leaf's spec names (a leaf replicated along an axis is counted once
    on it): TopK's thresholds by K4's sharded-row form, QSGD's norm as the
    square root of the summed f32 sums of squares (then K2 with it), the
    consensus distance's sums. ``_k`` and ``_c`` take the whole row's
    length, and the random compressors draw at the block's global element
    indices, so a rank's block of a gossip step is the dense step's block
    (QSGD's ``y_new`` within K2's ulps, the norm being summed in another
    order).

    The local step (``node_grads``, ``_Blocks._gathered_step``) gathers
    the nodes' whole weights, ``chunk`` nodes at a time (all N by
    default), runs the vmapped gradient on this rank's part of each node's
    batch (split over ``data``), and keeps this rank's block of the
    gradients' mean over the ``data`` ranks; the loss is the mean over the
    ``data`` ranks. Ranks along ``model`` compute the same step on the
    same gathered weights: the ``model`` axis splits storage and the
    gossip work, not compute.
    On a 1 x 1 mesh every collective is the identity and the round is
    bitwise the dense engine's."""

    def __init__(self, topology: Topology, group, specs: Dict[str, tuple],
                 shapes: Dict[str, Tuple[int, ...]],
                 chunk: Optional[int] = None):
        super().__init__(topology)
        for name, spec in specs.items():
            if spec and spec[0] is not None:
                raise ValueError(
                    f"leaf {name!r} has its node dim sharded ({spec[0]}): "
                    "a node a coordinate on those axes is "
                    "NodeMeshSubstrate's placement; the gossip-fsdp mesh "
                    "substrate holds every node")
        self._set_blocks(group, specs, shapes)
        self.chunk = self.num_nodes if chunk is None else max(1, int(chunk))

    def node_grads(self, grad_fn, params, batch):
        grads, losses = [], []
        for c0 in range(0, self.num_nodes, self.chunk):
            sl = slice(c0, min(self.num_nodes, c0 + self.chunk))
            g, loss = self._gathered_step(
                grad_fn, {name: p[sl] for name, p in params.items()},
                tree_map(lambda b: b[sl], batch), self.specs, (DATA_AXIS,))
            grads.append(g)
            losses.append(loss)
        if len(grads) == 1:
            return grads[0], losses[0]
        return ({name: torch.cat([g[name] for g in grads])
                 for name in grads[0]}, torch.cat(losses))


class NodeMeshSubstrate(_Blocks, ShardedSubstrate):
    """A node a set of coordinates on the mesh's node axes, its weights
    split over the rest: the rank holds its node's block of every leaf, its
    ``[1, ...]`` row cut by the leaf's spec past the node dim (``specs``:
    the node dim's entry names the node axes, the same for every leaf;
    ``shapes``: as ``_Blocks``). ``group`` is the rank's
    ``core.sharded.ShardGroup``, whose ``node_axes`` must be those axes. N
    is their size and a rank's node its row-major index over them
    (``ShardGroup.node_index``). The placements (``launch.sharding``):

    * gossip-dp: nodes over ``data`` on one pod and ``(pod, data)`` on
      two, rows over ``model``, each node's batch whole on its ranks;
    * gossip-fsdp on two pods (hierarchical DFL): the nodes are the pods,
      rows over ``(data, model)``, each node's batch split over ``data``.

    It is the sparse engine (``ShardedSubstrate``'s one-row hooks, node
    i's draws, participation by ``shift_masks``, ``node_mask_local`` and
    ``select_nodes``) on blocks, with ``MeshSubstrate``'s row operations
    over the row axes: a gossip step over a circulant C exchanges this
    rank's blocks over the node axes among the ranks of its other
    coordinates (``ShardGroup.shift_exchange``) and mixes what it
    receives with K1's received form (``mixing.mix_shifts``), the terms in
    the dense order, so a step's block is bitwise ``DenseSubstrate.mix``'s
    row i, that block. A C that is not circulant, which the dense engine
    mixes on this mesh, is mixed as the dense port mixes it: every node's
    block gathered over the node axes (``ShardGroup.node_rows``),
    ``DenseSubstrate.mix`` on that ``[N, block]`` stack, and row i kept.
    TopK's thresholds come from K4's sharded-row form over the leaf's row
    axes, QSGD's norm from the summed f32 sums of squares (then K2). The
    means over nodes and ``mean_tree`` are sums over the node axes'
    ranks divided by N, and the consensus distance sums each leaf over its
    row axes too.

    The local step (``node_grads``) is ``MeshSubstrate``'s for one node
    (``_Blocks._gathered_step``): the node's whole weights gathered over
    the row axes, the vmapped gradient on this rank's ``[1, B', ...]``
    part of its batch, and this rank's block of the gradients' mean over
    ``data`` where ``data`` splits the batch (gossip-fsdp on pods), else
    of its own gradient (gossip-dp). Ranks along ``model`` repeat the
    same step on the same weights; splitting that compute over ``model``
    (tensor parallelism) is not ported. On a data N x model 1 mesh every
    block is a whole row and the round is bitwise the sparse engine's on N
    ranks."""

    def __init__(self, topology: Topology, group, specs: Dict[str, tuple],
                 shapes: Dict[str, Tuple[int, ...]]):
        for name, spec in specs.items():
            if not spec or entry_axes(spec[0]) != group.node_axes:
                raise ValueError(
                    f"leaf {name!r}: node dim entry {spec[:1]}, not the "
                    f"group's node axes {group.node_axes}: a node is a "
                    "coordinate on them, the same for every leaf")
        node_axes = group.node_axes
        n = group.num_nodes
        if topology.num_nodes != n:
            raise ValueError(
                f"the topology has {topology.num_nodes} nodes, the mesh's "
                f"{' x '.join(node_axes)} axis"
                f"{'es' if len(node_axes) > 1 else ''} {n}")
        self.group = group
        super().__init__(topology, group)
        self._set_blocks(group, specs, shapes)
        # the leaves' specs with the node dim whole: what the local step
        # gathers over and cuts back to; the axes a node's batch is split
        # over
        self.node_specs = {name: (None,) + spec[1:]
                           for name, spec in self.specs.items()}
        self.batch_axes = (() if DATA_AXIS in node_axes
                           else group.mesh.axes_in_order((DATA_AXIS,)))
        self._dense = (None if topology.is_shift_structured()
                       else DenseSubstrate(topology))

    def node_index(self) -> int:
        return self.group.node_index()

    def mix(self, tree, edge_mask=None):
        if self._dense is None:
            return super().mix(tree, edge_mask)
        names = list(tree)
        stacked = self.group.node_rows([tree[name] for name in names])
        i = self.node_index()
        mixed = self._dense.mix(dict(zip(names, stacked)), edge_mask)
        return {name: mixed[name][i:i + 1].clone() for name in names}

    def node_grads(self, grad_fn, params, batch):
        return self._gathered_step(grad_fn, params, batch, self.node_specs,
                                   self.batch_axes)


class _MeshRows(RowOps):
    """``RowOps`` of a ``_Blocks`` substrate's leaves ``names`` (the rows given
    in that order): whole-row lengths, K4's sharded-row form for the leaves
    of each (dtype, row axes), norms from the summed sums of squares."""

    def __init__(self, sub: _Blocks, names):
        self.sub, self.names = sub, names

    def part(self, idx):
        return _MeshRows(self.sub, [self.names[i] for i in idx])

    def lengths(self, rows):
        return [self.sub.lengths[name] for name in self.names]

    def thresholds(self, rows, ks):
        out = [None] * len(rows)
        groups: Dict[tuple, list] = {}
        for i, (name, r) in enumerate(zip(self.names, rows)):
            groups.setdefault((r.dtype, self.sub.row_axes[name]), []).append(i)
        for (_, axes), idx in groups.items():
            found = ops.topk_threshold_sharded_many(
                [rows[i] for i in idx], [ks[i] for i in idx],
                self.sub.group.span(axes))
            for i, t in zip(idx, found):
                out[i] = t
        return out

    def norms(self, rows):
        """A row held whole on this rank takes the dense engine's norm; a
        split one the square root of its parts' f32 sums of squares,
        summed over its ranks."""
        mesh = self.sub.group.mesh
        split = {name: r.float().pow(2).sum(dim=1)
                 for name, r in zip(self.names, rows)
                 if mesh.axes_size(self.sub.row_axes[name]) > 1}
        sums = self.sub.sum_rows(split)
        return [sums[name].sqrt() if name in sums
                else WHOLE_ROWS.norms([r])[0]
                for name, r in zip(self.names, rows)]
