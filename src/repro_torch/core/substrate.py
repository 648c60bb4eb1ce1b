"""The node substrate: the node axis the shared DFL round runs over.

``repro_torch.core.dfl`` writes the round once against ``NodeSubstrate``;
``DenseSubstrate`` holds all N nodes stacked on a leading ``[N, ...]`` axis
of every leaf, which is how one card holds them. Its two hooks reach the
kernels:

  * ``mix``        — one gossip step X <- X C: the gossip kernel (K1) when
                     C is circulant, else the dense product ``mix_dense``.
  * ``choco_step`` — one CHOCO-G iteration after the mix: for TopK the gap
                     in the leaf dtype, its per-node threshold (K4) and the
                     fused move-and-update (K3); for other compressors the
                     unfused composition.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import mixing as mixing_lib
from repro_torch.core.compression import Compressor, TopK
from repro_torch.core.topology import Topology
from repro_torch.kernels import ops
from repro_torch.kernels.choco_fused import gap, move

Params = Dict[str, torch.Tensor]

__all__ = ["NodeSubstrate", "DenseSubstrate"]


class NodeSubstrate:
    """The node-axis contract (N = number of nodes):

      * ``mix(tree)``            — one uncompressed gossip step X <- X C.
      * ``mean_over_nodes(x)``   — mean over nodes of per-node values.
      * ``sum_per_node(x)``      — sum an array down to one value per node.
      * ``mean_tree(tree)``      — per-leaf f32 mean over nodes.
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

    def choco_step(self, comp: Compressor, x: Params, y: Params,
                   mixed_y: Params, gamma: float) -> Tuple[Params, Params]:
        """Consensus move x += gamma (C y - y), compress the gap per node,
        update the estimates y += Q(x_new - y) (Alg. 2 l.6-7, 11); returns
        (x_new, y_new). This is the unfused composition."""
        x_new, y_new = {}, {}
        for name in x:
            a, b = x[name], y[name]
            x_new[name] = move(a, b, mixed_y[name], gamma).to(a.dtype)
            y_new[name] = b + comp.per_node(x_new[name] - b)
        return x_new, y_new

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
        if device not in self._tables_on:
            nbr, w = self._table
            self._tables_on[device] = (torch.from_numpy(nbr).to(device),
                                       torch.from_numpy(w).to(device))
        return self._tables_on[device]

    def mix(self, tree):
        if self._table is None:
            return mixing_lib.mix_dense(tree, self.topology)
        out = {}
        for name, x in tree.items():
            nbr, w = self._table_on(x.device)
            out[name] = ops.gossip_mix(x.reshape(self.num_nodes, -1), nbr,
                                       w).reshape(x.shape)
        return out

    def mean_over_nodes(self, x):
        return x.mean(dim=0)

    def sum_per_node(self, x):
        return x.reshape(x.shape[0], -1).sum(dim=1)

    def mean_tree(self, tree):
        return {name: x.float().mean(dim=0) for name, x in tree.items()}

    def choco_step(self, comp, x, y, mixed_y, gamma):
        """TopK runs fused: d = gap in the leaf dtype, t = K4(d), then K3
        emits (x_new, y_new) in one pass per leaf. Others: unfused."""
        if not isinstance(comp, TopK):
            return super().choco_step(comp, x, y, mixed_y, gamma)
        n = self.num_nodes
        x_new, y_new = {}, {}
        for name in x:
            shape = x[name].shape
            a, b, my = (t[name].reshape(n, -1) for t in (x, y, mixed_y))
            d = gap(a, b, my, gamma)
            thresh = ops.topk_threshold(d, comp._k(d.shape[1]))
            xn, yn = ops.choco_topk(a, b, my, d, thresh, gamma)
            x_new[name], y_new[name] = xn.reshape(shape), yn.reshape(shape)
        return x_new, y_new
