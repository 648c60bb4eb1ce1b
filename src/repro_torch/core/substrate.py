"""The node substrate: the node axis the shared DFL round runs over.

``repro_torch.core.dfl`` writes the round once against ``NodeSubstrate``;
``DenseSubstrate`` holds all N nodes stacked on a leading ``[N, ...]`` axis
of every leaf, which is how one card holds them. Its hooks reach the
kernels:

  * ``mix``        — one gossip step X <- X C: the gossip kernel (K1), one
                     call for every leaf, when C is circulant, else the
                     dense product ``mix_dense``.
  * ``choco_step`` — one CHOCO-G iteration after the mix:
                     TopK: every leaf's gap in the leaf dtype, their
                     per-node thresholds in one call (K4), then the fused
                     move-and-update (K3) per leaf;
                     QSGD: the gap's per-node f32 norm, the noise from the
                     RNG seam and the fused move-and-quantize (K2);
                     any other compressor: the move (K7), ``compress``
                     on the gaps, and ``y + q``.
  * ``compress``   — Q on every node's slice of each leaf of a tree
                     whose leading axis is the node axis, with its draws
                     from the seam: QSGD every leaf's per-node norm and one
                     K6 call for the leaves of each dtype, any other
                     compressor leaf by leaf.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import mixing as mixing_lib
from repro_torch.core.compression import QSGD, Compressor, TopK
from repro_torch.core.topology import Topology
from repro_torch.device import to_device
from repro_torch.kernels import ops
from repro_torch.kernels.choco_fused import gap

Params = Dict[str, torch.Tensor]

__all__ = ["NodeSubstrate", "DenseSubstrate"]


class NodeSubstrate:
    """The node-axis contract (N = number of nodes):

      * ``mix(tree)``            — one uncompressed gossip step X <- X C.
      * ``mean_over_nodes(x)``   — mean over nodes of per-node values.
      * ``sum_per_node(x)``      — sum an array down to one value per node.
      * ``mean_tree(tree)``      — per-leaf f32 mean over nodes.
      * ``compress(...)``        — Q on every node's slice of a tree.
      * ``choco_step(...)``      — one CHOCO-G iteration after the mix.
    """

    num_nodes: int

    def mix(self, tree: Params) -> Params:
        raise NotImplementedError

    def mean_over_nodes(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sum_per_node(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mean_tree(self, tree: Params) -> Params:
        raise NotImplementedError

    def compress(self, comp: Compressor, tree: Params, draws=None,
                 round_idx: int = 0, step: int = 0) -> Params:
        """Q on every node's slice of each leaf of ``tree``, whose leading
        axis is the node axis (the nodes this substrate holds), each leaf
        with its draws for gossip step ``step`` of round ``round_idx`` from
        the seam ``draws``: one ``per_node_many`` call for the tree, which
        makes one K6 call per dtype under QSGD and goes leaf by leaf for
        the other compressors."""
        names = list(tree)
        us = [comp.draw(draws, round_idx, step, name, tree[name][0].numel())
              for name in names]
        return dict(zip(names, comp.per_node_many([tree[name]
                                                   for name in names], us)))

    def choco_step(self, comp: Compressor, x: Params, y: Params,
                   mixed_y: Params, gamma: float, draws=None,
                   round_idx: int = 0, step: int = 0
                   ) -> Tuple[Params, Params]:
        """Consensus move x += gamma (C y - y), compress the gap per node,
        update the estimates y += Q(x_new - y) (Alg. 2 l.6-7, 11); returns
        (x_new, y_new). The unfused composition: the move and the gap in
        one pass (K7) per leaf, then ``compress`` on every gap with the
        draws for gossip step ``step`` of round ``round_idx`` from the seam
        ``draws``, then the add."""
        n = self.num_nodes
        x_new, gaps = {}, {}
        for name in x:
            a, b, my = (t[name].reshape(n, -1) for t in (x, y, mixed_y))
            x_new[name], gaps[name] = ops.choco_move(a, b, my, gamma)
        q = self.compress(comp, gaps, draws, round_idx, step)
        return ({name: v.reshape(x[name].shape) for name, v in x_new.items()},
                {name: (y[name].reshape(n, -1) + q[name]).reshape(
                    x[name].shape) for name in x})

    def consensus_sq(self, params: Params) -> torch.Tensor:
        """||X (I - J)||_F^2 / N (Lemma 1's drift), in f32."""
        mean = self.mean_tree(params)
        dev = None
        for name, leaf in params.items():
            d = (leaf.float() - mean[name].float()) ** 2
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
        self._tables_on = {}

    def _table_on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The gossip table on ``device``, copied there at its first mix
        without blocking the host."""
        if device not in self._tables_on:
            self._tables_on[device] = tuple(
                to_device(torch.from_numpy(a), device) for a in self._table)
        return self._tables_on[device]

    def mix(self, tree):
        if self._table is None:
            return mixing_lib.mix_dense(tree, self.topology)
        if not tree:
            return {}
        names = list(tree)
        nbr, w = self._table_on(tree[names[0]].device)
        mixed = ops.gossip_mix_many(
            [tree[name].reshape(self.num_nodes, -1) for name in names], nbr, w)
        return {name: m.reshape(tree[name].shape)
                for name, m in zip(names, mixed)}

    def mean_over_nodes(self, x):
        return x.mean(dim=0)

    def sum_per_node(self, x):
        return x.reshape(x.shape[0], -1).sum(dim=1)

    def mean_tree(self, tree):
        return {name: x.float().mean(dim=0) for name, x in tree.items()}

    def choco_step(self, comp, x, y, mixed_y, gamma, draws=None,
                   round_idx=0, step=0):
        """TopK and QSGD run fused, emitting (x_new, y_new) in one pass per
        leaf. TopK: every leaf's gap d in the leaf dtype, all their
        thresholds in one K4 call, then K3 per leaf. QSGD, per leaf: d's
        per-node f32 norm and K2 (which recomputes d bitwise). Other
        compressors: the unfused composition."""
        if not isinstance(comp, (TopK, QSGD)):
            return super().choco_step(comp, x, y, mixed_y, gamma, draws,
                                      round_idx, step)
        n = self.num_nodes
        rows = {name: tuple(t[name].reshape(n, -1) for t in (x, y, mixed_y))
                for name in x}
        x_new, y_new = {}, {}
        if isinstance(comp, TopK):
            gaps = [gap(a, b, my, gamma) for a, b, my in rows.values()]
            threshs = ops.topk_threshold_many(
                gaps, [comp._k(d.shape[1]) for d in gaps])
            for (name, (a, b, my)), d, t in zip(rows.items(), gaps, threshs):
                x_new[name], y_new[name] = ops.choco_topk(a, b, my, d, t,
                                                          gamma)
        else:
            for name, (a, b, my) in rows.items():
                d = gap(a, b, my, gamma)
                norm = torch.linalg.vector_norm(d.float(), dim=1)
                noise = comp.draw(draws, round_idx, step, name, d.shape[1])
                x_new[name], y_new[name] = ops.choco_qsgd(
                    a, b, my, noise, norm, gamma, comp.levels,
                    comp._c(d.shape[1]))
        return ({name: v.reshape(x[name].shape) for name, v in x_new.items()},
                {name: v.reshape(x[name].shape) for name, v in y_new.items()})
