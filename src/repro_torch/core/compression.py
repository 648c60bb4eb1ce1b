"""Compression operators Q for C-DFL (paper Sec. V-A), on tensors.

Each operator satisfies Assumption 2, E ||Q(x) - x||^2 <= (1 - delta) ||x||^2,
acts on one vector (a leaf flattened) and returns a dense tensor with the
compression applied; wire savings are accounted through ``bits_per_value``.
``per_node`` applies Q to every node's slice of a stacked ``[N, ...]`` leaf,
the batch dimension that the reference writes as ``vmap``.

This slice ports ``Identity`` and ``TopK``; TopK's threshold select and mask
run the K4 and K5 kernels on CUDA tensors (``repro_torch.kernels.ops``).
QSGD, RandK and RandomizedGossip need the RNG seam and come next (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import ops

__all__ = [
    "Compressor",
    "Identity",
    "TopK",
    "make_compressor",
    "compress_tree",
    "tree_wire_bits",
]


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

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return x

    def per_node(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Q applied to each node's slice x[i] of a stacked leaf."""
        return x


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

    def __call__(self, x, generator=None):
        return self.per_node(x.reshape(1, -1)).reshape(x.shape)

    def per_node(self, x, generator=None):
        rows = x.reshape(x.shape[0], -1)
        thresh = ops.topk_threshold(rows, self._k(rows.shape[1]))
        return ops.topk_mask(rows, thresh).reshape(x.shape)


_REGISTRY = {"identity": Identity, "top_k": TopK}
_NEXT_SLICE = ("qsgd", "rand_k", "rand_gossip")


def make_compressor(name: str, **kwargs) -> Compressor:
    """Build a compressor by name: "identity" or "top_k" (``frac``)."""
    if name in _NEXT_SLICE:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet: it needs the RNG seam "
            "(ROADMAP.md, modules to port)")
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown compressor {name!r}; options: {sorted(_REGISTRY)}"
        ) from None


def compress_tree(comp: Compressor, tree: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """Apply Q leaf-wise to one node's parameters."""
    return {name: comp(leaf, generator) for name, leaf in tree.items()}


def tree_wire_bits(comp: Compressor, tree) -> float:
    """Total wire bits to transmit one compressed copy of ``tree``."""
    total = 0.0
    for leaf in tree.values():
        d = int(np.prod(leaf.shape)) if len(leaf.shape) else 1
        total += comp.bits_per_value(d) * d
    return total
