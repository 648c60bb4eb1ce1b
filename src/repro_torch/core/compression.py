"""Compression operators Q for C-DFL (paper Sec. V-A), on tensors.

Each operator satisfies Assumption 2, E ||Q(x) - x||^2 <= (1 - delta) ||x||^2,
acts on one vector (a leaf flattened) and returns a dense tensor with the
compression applied; wire savings are accounted through ``bits_per_value``.
``per_node`` applies Q to every node's slice of a stacked ``[N, ...]`` leaf,
the batch dimension that the reference writes as ``vmap``.

All five of the reference's operators are ported: ``Identity``, ``TopK``,
``QSGD``, ``RandK`` and ``RandomizedGossip``. The random ones take their
uniform draws as a tensor (``draw_shape`` says which), which the round
gets from the RNG seam (``repro_torch.core.rng``). On CUDA tensors TopK's
threshold select and mask run K4 and K5, QSGD runs K6 and RandK's
threshold over its scores runs K4 (``repro_torch.kernels.ops``).
``per_node_many`` applies Q to every stacked leaf of a tree: leaf by leaf,
but for TopK one K4 call and one K5 call, and for QSGD one K6 call, for
the leaves of each dtype.

What Q reads of a whole row (its length d, TopK's k-th largest |x|,
QSGD's norm) comes from a ``RowOps``: ``WHOLE_ROWS``, the default, when
every row is whole in its tensor; on the gossip-fsdp mesh a row is split
over ranks and the substrate passes one that reads the whole row across
them (``core.substrate.MeshSubstrate``), so ``_k`` and ``_c`` always see
the row's global length.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

__all__ = [
    "Compressor",
    "Identity",
    "TopK",
    "RandK",
    "QSGD",
    "RandomizedGossip",
    "make_compressor",
    "compress_tree",
    "tree_wire_bits",
    "RowOps",
    "WHOLE_ROWS",
]


def by_dtype(leaves: List[torch.Tensor], fn: Callable,
             *aligned: Sequence[Any]) -> List[Any]:
    """``fn`` on the leaves of each dtype in one call (``fn(group,
    *aligned_groups) -> one output per leaf``, each list of ``aligned``
    cut the same way), the outputs back in the leaves' order."""
    out: List[Any] = [None] * len(leaves)
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        for i, o in zip(idx, fn([leaves[i] for i in idx],
                                *[[a[i] for i in idx] for a in aligned])):
            out[i] = o
    return out


class RowOps:
    """What a compressor reads of whole rows, for ``[R, D]`` row tensors:
    ``lengths`` (each tensor's whole row length), ``thresholds`` (each
    row's exact k-th largest |x| for the tensors' ``ks``, one K4 call for
    the tensors of each dtype) and ``norms`` (each row's f32 2-norm), for
    the tensors it was made for, in order; ``part(idx)`` the same for the
    tensors at positions ``idx`` of those. This one holds every row whole
    in its tensor."""

    def part(self, idx: Sequence[int]) -> "RowOps":
        return self

    def lengths(self, rows: Sequence[torch.Tensor]) -> List[int]:
        return [r.shape[1] for r in rows]

    def thresholds(self, rows: Sequence[torch.Tensor],
                   ks: Sequence[int]) -> List[torch.Tensor]:
        return by_dtype(list(rows), ops.topk_threshold_many, ks)

    def norms(self, rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.linalg.vector_norm(r.float(), dim=1) for r in rows]


WHOLE_ROWS = RowOps()


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base compression operator (the identity)."""

    name: str = "identity"

    def delta(self, d: int) -> float:
        """Compression ratio delta of Assumption 2 for dimension d."""
        return 1.0

    def bits_per_value(self, d: int) -> float:
        """Average wire bits per original coordinate (fp32 baseline = 32)."""
        return 32.0

    def draw_shape(self, d: int) -> Optional[Tuple[int, ...]]:
        """Shape of the uniform draws Q needs per node for a d-vector, or
        None when Q draws nothing."""
        return None

    def draw(self, draws, round_idx: int, step: int, leaf: str, d: int,
             node_ids=None) -> Optional[torch.Tensor]:
        """This operator's draws ``[len(node_ids), *draw_shape(d)]`` for one
        leaf from the seam ``draws`` (``repro_torch.core.rng``), one row
        per node id (None: every node), or None."""
        return self.draw_many(draws, round_idx, step, [leaf], [d],
                              node_ids)[0]

    def draw_many(self, draws, round_idx: int, step: int,
                  leaves: Sequence[str], ds: Sequence[int],
                  node_ids=None, blocks=None) -> List[Optional[torch.Tensor]]:
        """``draw`` for each leaf of ``leaves`` (d-vectors of ``ds``), in
        one ``uniform_many`` call on the seam. ``blocks[i]``: leaf i is
        held as a block of its whole ``[d]`` row (``core.rng.Block``); a
        draw of one value per coordinate is then drawn at the block's
        global indices, ``[rows, block elements]``, and a draw of one
        value a node (``draw_shape`` ``()``) whole."""
        shapes = [self.draw_shape(d) for d in ds]
        if all(s is None for s in shapes):
            return [None] * len(shapes)
        if draws is None:
            raise ValueError(f"compressor {self.name!r} draws random numbers; "
                             "pass the round's draws (DFLState.draws)")
        if blocks is not None:
            blocks = [b if s == (d,) else None
                      for b, s, d in zip(blocks, shapes, ds)]
            return draws.uniform_many(round_idx, step, leaves, shapes,
                                      node_ids, blocks=blocks)
        return draws.uniform_many(round_idx, step, leaves, shapes, node_ids)

    def __call__(self, x: torch.Tensor,
                 draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Q on one vector x (any shape), with draws of ``draw_shape``."""
        if draws is not None:
            draws = draws.reshape((1,) + self.draw_shape(x.numel()))
        return self.per_node(x.reshape(1, -1), draws).reshape(x.shape)

    def per_node(self, x: torch.Tensor,
                 draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Q applied to each node's slice x[i] of a stacked leaf, with
        ``draws`` ``[N, *draw_shape(x[i].numel())]``."""
        return x

    def per_node_many(self, xs: Sequence[torch.Tensor],
                      draws: Sequence[Optional[torch.Tensor]],
                      row_ops: RowOps = WHOLE_ROWS) -> List[torch.Tensor]:
        """``per_node`` on each stacked leaf ``xs[i]`` with ``draws[i]``;
        ``row_ops`` reads their whole rows (a compressor that needs
        nothing of the whole row ignores it)."""
        return [self.per_node(x, u) for x, u in zip(xs, draws)]


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    name: str = "identity"


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Keep the ceil(frac*d) largest-|.| coordinates; zero the rest. The
    threshold is the k-th largest magnitude in the input dtype and ties
    are kept (inclusive), as in the reference. ``delta = k/d``; the wire
    carries value + index bits per kept coordinate."""

    name: str = "top_k"
    frac: float = 0.5

    def _k(self, d: int) -> int:
        return max(1, int(np.ceil(self.frac * d)))

    def delta(self, d: int) -> float:
        return self._k(d) / d

    def bits_per_value(self, d: int) -> float:
        k = self._k(d)
        return (32.0 + np.ceil(np.log2(max(d, 2)))) * k / d

    def per_node(self, x, draws=None):
        return self.per_node_many([x], [draws])[0]

    def per_node_many(self, xs, draws, row_ops=WHOLE_ROWS):
        """One K4 call for the thresholds and one K5 call for the masks of
        the leaves of each dtype (one of each for a tree of one dtype)."""
        def mask(group, ks, idx):
            return ops.topk_mask_many(group, row_ops.part(idx).thresholds(
                group, ks))

        rows = [x.reshape(x.shape[0], -1) for x in xs]
        masked = by_dtype(rows, mask, [self._k(d) for d in
                                       row_ops.lengths(rows)],
                          range(len(rows)))
        return [m.reshape(x.shape) for x, m in zip(xs, masked)]


def _rows_draws(comp: Compressor, rows: torch.Tensor,
                draws: Optional[torch.Tensor]) -> torch.Tensor:
    """``draws`` checked to be one row of ``draw_shape`` per row of
    ``rows``: the substrate asks the seam for the nodes it holds."""
    want = (rows.shape[0],) + comp.draw_shape(rows.shape[1])
    if draws is None or tuple(draws.shape) != want:
        got = None if draws is None else tuple(draws.shape)
        raise ValueError(f"compressor {comp.name!r} needs uniform draws of "
                         f"shape {want}, got {got}")
    return draws


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Keep k = ceil(frac*d) coordinates chosen by uniform scores: those
    whose score is at least the k-th largest (K4 on the f32 scores, ties
    inclusive), as the reference's ``lax.top_k`` threshold. The shared
    seed means only values travel."""

    name: str = "rand_k"
    frac: float = 0.5

    def _k(self, d: int) -> int:
        return max(1, int(np.ceil(self.frac * d)))

    def delta(self, d: int) -> float:
        return self._k(d) / d

    def bits_per_value(self, d: int) -> float:
        return 32.0 * self._k(d) / d

    def draw_shape(self, d):
        return (d,)

    def per_node(self, x, draws=None):
        return self.per_node_many([x], [draws])[0]

    def per_node_many(self, xs, draws, row_ops=WHOLE_ROWS):
        """One K4 call a leaf on its scores (the whole row's k-th largest
        score through ``row_ops``), then the keep."""
        out = []
        for i, (x, u) in enumerate(zip(xs, draws)):
            rows = x.reshape(x.shape[0], -1)
            scores = _rows_draws(self, rows, u)
            leaf = row_ops.part([i])
            (d,) = leaf.lengths([rows])
            (thresh,) = leaf.thresholds([scores], [self._k(d)])
            kept = torch.where(scores >= thresh[:, None], rows,
                               torch.zeros_like(rows))
            out.append(kept.reshape(x.shape))
        return out


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """Random quantization qsgd_s (paper Sec. V-A), rescaled by 1/c so that
    Assumption 2 holds with delta = 1/c, c = 1 + min(d/s^2, sqrt(d)/s):
    the f32 norm of each node's slice, then K6."""

    name: str = "qsgd"
    levels: int = 16  # s

    def _c(self, d: int) -> float:
        s = float(self.levels)
        return 1.0 + min(d / (s * s), np.sqrt(d) / s)

    def delta(self, d: int) -> float:
        return 1.0 / self._c(d)

    def bits_per_value(self, d: int) -> float:
        # sign + level index per coordinate + one fp32 norm per vector.
        return 1.0 + np.ceil(np.log2(self.levels + 1)) + 32.0 / d

    def draw_shape(self, d):
        return (d,)

    def per_node(self, x, draws=None):
        return self.per_node_many([x], [draws])[0]

    def per_node_many(self, xs, draws, row_ops=WHOLE_ROWS):
        """Every leaf's per-node f32 norm, then one K6 call for the leaves
        of each dtype (one call for a tree of one dtype)."""
        rows = [x.reshape(x.shape[0], -1) for x in xs]
        noises = [_rows_draws(self, r, u) for r, u in zip(rows, draws)]
        cs = [self._c(d) for d in row_ops.lengths(rows)]
        qs = by_dtype(rows, lambda r, u, n, c: ops.qsgd_quantize_many(
            r, u, n, self.levels, c), noises, row_ops.norms(rows), cs)
        return [q.reshape(x.shape) for x, q in zip(xs, qs)]


@dataclasses.dataclass(frozen=True)
class RandomizedGossip(Compressor):
    """Q(x) = x with probability p else 0, per node and leaf: one uniform u
    each, kept where u < p (the reference's ``bernoulli(key, p)`` is
    ``uniform(key, ()) < p`` in f32); delta = p."""

    name: str = "rand_gossip"
    p: float = 0.8

    def delta(self, d: int) -> float:
        return self.p

    def bits_per_value(self, d: int) -> float:
        return 32.0 * self.p

    def draw_shape(self, d):
        return ()

    def per_node(self, x, draws=None):
        u = _rows_draws(self, x.reshape(x.shape[0], -1), draws)
        keep = u < float(np.float32(self.p))
        return torch.where(keep.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                           torch.zeros_like(x))


_REGISTRY = {
    "identity": Identity,
    "top_k": TopK,
    "rand_k": RandK,
    "qsgd": QSGD,
    "rand_gossip": RandomizedGossip,
}


def make_compressor(name: str, **kwargs) -> Compressor:
    """Build a compressor by name: "identity", "top_k" (``frac``),
    "rand_k" (``frac``), "qsgd" (``levels``), "rand_gossip" (``p``)."""
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown compressor {name!r}; options: {sorted(_REGISTRY)}"
        ) from None


def compress_tree(comp: Compressor, tree: Dict[str, torch.Tensor],
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Apply Q leaf-wise to one node's parameters, with each leaf's draws
    (of ``draw_shape``): every leaf a stack of one node, all through one
    ``per_node_many`` call (under TopK one K4 and one K5 call per dtype,
    under QSGD one K6 call per dtype)."""
    rows = [leaf.reshape(1, -1) for leaf in tree.values()]
    us = [None if draws is None
          else draws[name].reshape((1,) + comp.draw_shape(r.shape[1]))
          for name, r in zip(tree, rows)]
    return {name: q.reshape(leaf.shape) for (name, leaf), q in
            zip(tree.items(), comp.per_node_many(rows, us))}


def tree_wire_bits(comp: Compressor, tree) -> float:
    """Total wire bits to transmit one compressed copy of ``tree``."""
    total = 0.0
    for leaf in tree.values():
        d = int(np.prod(leaf.shape)) if len(leaf.shape) else 1
        total += comp.bits_per_value(d) * d
    return total
