"""Model-averaging (gossip) primitives over a stacked node axis.

Every leaf carries a leading node dimension N; one gossip step is X <- X C
along it. ``mix_dense`` is the literal matrix form, correct for any doubly
stochastic C (a plain product, as the reference leaves it to XLA), with an
optional edge mask (``masked_mixing_matrix``); ``mix_dense_power`` folds
tau2 plain steps into one product with C^tau2. The circulant case runs the
gossip kernel through ``gossip_table`` and
``repro_torch.kernels.ops.gossip_mix_many``
(``core.substrate.DenseSubstrate``). On the sharded engine a node holds
its own leaves only, and ``mix_shifts`` mixes them with the copies an
exchange brings from its neighbours, one per shift of a circulant C,
through K1's received-buffer form
(``repro_torch.kernels.ops.gossip_mix_received_many``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.topology import Topology
from repro_torch.device import to_device
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]

__all__ = [
    "contract",
    "mix_dense",
    "mix_dense_power",
    "masked_mixing_matrix",
    "gossip_table",
    "masked_gossip_weights",
    "masked_shift_weights",
    "shift_weights",
    "mix_shifts",
    "gossip_copies_per_step",
    "mixing_bytes_per_step",
]


def _edge_tables(topology: Topology) -> Tuple[np.ndarray, np.ndarray]:
    """(has_edge [N, N] bool, eidx [N, N] int64) over ``topology.edges()``."""
    n = topology.num_nodes
    has_edge = np.zeros((n, n), dtype=bool)
    eidx = np.zeros((n, n), dtype=np.int64)
    for e, (a, b) in enumerate(topology.edges()):
        has_edge[a, b] = has_edge[b, a] = True
        eidx[a, b] = eidx[b, a] = e
    return has_edge, eidx


def masked_mixing_matrix(topology: Topology, edge_mask: torch.Tensor,
                         dtype) -> torch.Tensor:
    """The confusion matrix of a round with masked edges, on
    ``edge_mask``'s device (its tables copied there without blocking the
    host). ``edge_mask`` is an [E] 0/1 vector over
    ``topology.edges()``; a masked edge carries no gossip, and its weight
    moves onto both endpoints' diagonals, so the matrix stays symmetric
    doubly stochastic. At all-ones masks every term is an exact ``* 1`` or
    ``+ 0`` and the matrix is bitwise ``topology.mixing``."""
    dev = edge_mask.device
    cm = to_device(torch.from_numpy(topology.mixing).to(dtype), dev)
    if topology.num_edges == 0:
        return cm
    has_edge, eidx = (to_device(torch.from_numpy(a), dev)
                      for a in _edge_tables(topology))
    one = torch.ones((), dtype=dtype, device=dev)
    gate = torch.where(has_edge, edge_mask.to(dtype)[eidx], one)
    # removed[i] = sum_j C[j, i] (1 - gate[j, i]): the weight node i no
    # longer receives, returned to its self loop
    removed = torch.sum(cm * (one - gate), dim=0)
    return cm * gate + torch.diag(removed)


def contract(cm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One dense gossip step of a leaf ``x`` [N, ...]: out[i] = sum_j
    cm[j, i] x[j] in cm's dtype, cast back to x's."""
    return torch.einsum("ji,j...->i...", cm, x.to(cm.dtype)).to(x.dtype)


_MATRICES: Dict[tuple, torch.Tensor] = {}
_MATRICES_MAX = 64


def _matrix_on(mixing: np.ndarray, dtype, device) -> torch.Tensor:
    """``mixing`` in ``dtype`` on ``device``, each distinct one copied there
    once without blocking the host (a bounded FIFO): a captured round (the
    executor's static graphs) then reads a tensor it holds, and copies
    nothing from the host while it is captured."""
    key = (mixing.tobytes(), mixing.shape, str(dtype), torch.device(device))
    hit = _MATRICES.get(key)
    if hit is None:
        if len(_MATRICES) >= _MATRICES_MAX:
            _MATRICES.pop(next(iter(_MATRICES)))
        hit = _MATRICES[key] = to_device(torch.from_numpy(mixing).to(dtype),
                                         torch.device(device))
    return hit


def mix_dense(params: Params, topology: Topology,
              edge_mask: Optional[torch.Tensor] = None) -> Params:
    """One gossip step as a dense contraction over the node axis: every
    leaf [N, ...] -> [N, ...] with out[i] = sum_j C[j, i] leaf[j], in the
    leaf dtype promoted to at least f32 (``contract``). ``edge_mask`` ([E]
    over ``topology.edges()``) replaces C with ``masked_mixing_matrix``,
    bitwise the same at all ones."""

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, torch.float32)
        if edge_mask is None:
            cm = _matrix_on(topology.mixing, dtype, x.device)
        else:
            cm = masked_mixing_matrix(topology, edge_mask.to(x.device), dtype)
        return contract(cm, x)

    return {name: mix_leaf(x) for name, x in params.items()}


def mix_dense_power(params: Params, topology: Topology, tau2: int) -> Params:
    """tau2 plain gossip steps as one contraction with C^tau2, the power
    taken in float64 by numpy as the reference does. Equal to tau2
    ``mix_dense`` steps up to rounding; plain DFL only, since C-DFL
    compresses between steps."""
    cpow = np.linalg.matrix_power(topology.mixing, int(tau2))
    topo_pow = Topology(name=f"{topology.name}^{int(tau2)}", mixing=cpow,
                        neighbors=topology.neighbors,  # unused by mix_dense
                        self_weights=np.diag(cpow).copy())
    return mix_dense(params, topo_pow)


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


def masked_gossip_weights(topology: Topology,
                          edge_mask: np.ndarray) -> np.ndarray:
    """The gossip table's weights ``w [N, deg + 1]`` float32 for a round
    with the [E] 0/1 ``edge_mask`` over ``topology.edges()``, the rows of
    ``masked_shift_weights`` for every node: with ``m_ik`` the mask of the
    edge between i and (i + s_k) mod N, ``w[i, 0] = w_self + sum_k w_k
    (1 - m_ik)`` and ``w[i, k + 1] = w_k m_ik``, each term in f32. At all
    ones every term is an exact ``* 1.0`` or ``+ 0.0``, so the weights are
    bitwise ``gossip_table``'s; a node with every edge masked keeps
    ``w_self + sum_k w_k`` and zeros."""
    nbr, w = gossip_table(topology)
    mask = np.asarray(edge_mask).reshape(-1)
    if mask.shape != (topology.num_edges,):
        raise ValueError(f"edge mask has {mask.size} entries, the topology "
                         f"{topology.num_edges} edges")
    _, eidx = _edge_tables(topology)
    nodes = np.arange(topology.num_nodes)
    one = np.float32(1.0)
    out = np.empty_like(w)
    w_self = w[:, 0].copy()
    for k in range(nbr.shape[1]):
        m = mask[eidx[nodes, nbr[:, k]]].astype(np.float32)
        w_self = w_self + w[:, k + 1] * (one - m)
        out[:, k + 1] = w[:, k + 1] * m
    out[:, 0] = w_self
    return out


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


def shift_weights(shifts: Sequence[Tuple[int, float]], self_weight: float,
                  shift_masks: Optional[Sequence] = None) -> np.ndarray:
    """One node's K1 weights ``[deg + 1]`` float32, self weight first, in
    the order of ``shifts``: the static ones, or those of
    ``masked_shift_weights`` under the node's 0/1 ``shift_masks`` (host
    values, one per shift)."""
    if shift_masks is None:
        return np.asarray([self_weight] + [w for _, w in shifts], np.float32)
    if len(shift_masks) != len(shifts):
        raise ValueError(f"{len(shift_masks)} shift masks for "
                         f"{len(shifts)} shifts")
    w_self, eff = masked_shift_weights(
        shifts, self_weight, [torch.as_tensor(m) for m in shift_masks])
    # repro-lint: disable=no-host-coercion-of-device-scalars (host tensors of host masks)
    return torch.stack([w_self, *eff]).numpy()


Exchange = Callable[[List[torch.Tensor], Sequence[int]], List[torch.Tensor]]


def mix_shifts(params: Params, shifts: Sequence[Tuple[int, float]],
               self_weight: float, exchange: Exchange,
               shift_masks: Optional[Sequence] = None) -> Params:
    """One gossip step of a circulant C for the one node whose leaves
    ``params`` holds (any shapes, ``[1, ...]`` on the sharded engine).

    ``shifts``: ``[(s, w)]``, the node i receives weight w from node
    (i - s) mod N, as the reference's ``mix_ppermute_shifts``;
    ``self_weight`` is C's diagonal. ``exchange(leaves, [s, ...])`` sends
    the flat leaves to (i + s) mod N and returns, for each leaf, the
    ``[deg, D]`` copies received from (i - s) mod N, one row per shift
    (``core.sharded.NodeGroup.shift_exchange``). Every shift is exchanged
    whatever the masks, so every node makes the same sends and receives:
    ``shift_masks`` (this node's 0/1 host value per shift) gate the
    weights (``shift_weights``), never the traffic. The weights go to the
    leaves' device once per distinct value, and K1's received form mixes
    the leaves of each dtype in one call. An empty shift list exchanges
    nothing and keeps ``self_weight`` times each leaf (C = I)."""
    if not params:
        return {}
    names = list(params)
    flat = [params[name].reshape(-1) for name in names]
    device = flat[0].device
    w = _matrix_on(shift_weights(shifts, self_weight, shift_masks),
                   torch.float32, device)
    recvs = exchange(flat, [int(s) for s, _ in shifts])
    out: Dict[str, torch.Tensor] = {}
    for dtype in dict.fromkeys(x.dtype for x in flat):
        idx = [i for i, x in enumerate(flat) if x.dtype == dtype]
        mixed = ops.gossip_mix_received_many([flat[i] for i in idx],
                                             [recvs[i] for i in idx], w)
        for i, m in zip(idx, mixed):
            out[names[i]] = m.reshape(params[names[i]].shape)
    return {name: out[name] for name in names}


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


def mixing_bytes_per_step(topology: Topology, param_bytes: int,
                          sparse: bool) -> int:
    """Bytes each node receives per gossip step: ``param_bytes`` times
    ``gossip_copies_per_step`` of the sparse or the dense engine."""
    engine = "sparse" if sparse else "dense"
    return gossip_copies_per_step(topology, engine) * param_bytes
