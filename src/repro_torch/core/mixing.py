"""Model-averaging (gossip) primitives over a stacked node axis.

Every leaf carries a leading node dimension N; one gossip step is X <- X C
along it. ``mix_dense`` is the literal matrix form, correct for any doubly
stochastic C (a plain product, as the reference leaves it to XLA). The
circulant case runs the gossip kernel through ``gossip_table`` and
``repro_torch.kernels.ops.gossip_mix`` (``core.substrate.DenseSubstrate``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.topology import Topology

Params = Dict[str, torch.Tensor]

__all__ = [
    "mix_dense",
    "gossip_table",
    "masked_shift_weights",
    "gossip_copies_per_step",
]


def mix_dense(params: Params, topology: Topology) -> Params:
    """One gossip step as a dense contraction over the node axis: every
    leaf [N, ...] -> [N, ...] with out[i] = sum_j C[j, i] leaf[j], in the
    leaf dtype promoted to at least f32."""

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, torch.float32)
        cm = torch.as_tensor(topology.mixing, dtype=dtype, device=x.device)
        return torch.einsum("ji,j...->i...", cm, x.to(dtype)).to(x.dtype)

    return {name: mix_leaf(x) for name, x in params.items()}


def gossip_table(topology: Topology) -> Tuple[np.ndarray, np.ndarray]:
    """(nbr [N, deg] int32, w [N, deg + 1] float32) for the gossip kernel,
    from the circulant structure ``topology.shifts()``: node i receives
    weight w_s = C[i + s, i] from node (i + s) mod N, and keeps its own
    C[i, i] as w[i, 0]. With these, the kernel's out[i] equals
    ``mix_dense``'s sum_j C[j, i] x[j]. Raises for a non-circulant C."""
    if not topology.is_shift_structured():
        raise ValueError(f"{topology.name} is not circulant; use mix_dense")
    n = topology.num_nodes
    shifts = topology.shifts()
    nodes = np.arange(n)
    nbr = np.stack([(nodes + s) % n for s, _ in shifts], axis=1) \
        if shifts else np.zeros((n, 0), np.int64)
    w = np.empty((n, len(shifts) + 1), np.float32)
    w[:, 0] = topology.self_weights
    for k, (_, weight) in enumerate(shifts):
        w[:, k + 1] = weight
    return nbr.astype(np.int32), w


def masked_shift_weights(
    shifts: Sequence[Tuple[int, float]],
    self_weight: float,
    shift_masks: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """(effective self weight, per-shift effective weights) for one node,
    in f32. A masked shift (``shift_masks[k] == 0``) contributes 0 and its
    weight returns to the self loop, ``w_self + sum_k w_k (1 - m_k)``; at
    all-ones masks each term is an exact ``+ 0.0`` / ``* 1.0``, so the
    weights are bitwise the static ones. These fill a row of the gossip
    kernel's per-node weight table."""
    one = torch.tensor(1.0, dtype=torch.float32)
    w_self = torch.tensor(self_weight, dtype=torch.float32)
    for (_, w), m in zip(shifts, shift_masks):
        w_self = w_self + torch.tensor(w, dtype=torch.float32) * (
            one - m.to(torch.float32))
    eff = tuple(torch.tensor(w, dtype=torch.float32) * m.to(torch.float32)
                for (_, w), m in zip(shifts, shift_masks))
    return w_self, eff


def gossip_copies_per_step(topology: Topology, engine: str) -> int:
    """Model copies each node RECEIVES per gossip step, the one wire
    accounting rule: "sparse" charges per-neighbour traffic (max degree, what
    a network deployment ships), "dense" the all-gather's N - 1 copies,
    "auto" sparse iff the topology is circulant."""
    if engine == "auto":
        engine = "sparse" if topology.is_shift_structured() else "dense"
    if engine == "sparse":
        return topology.max_degree
    if engine == "dense":
        return max(topology.num_nodes - 1, 0)
    raise ValueError(f"unknown engine {engine!r}")
