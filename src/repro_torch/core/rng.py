"""The port's RNG seam: where every random draw of a C-DFL round comes from.

The reference derives its randomness by folding JAX threefry keys
(``repro.core.dfl.round_keys`` and ``_communicate_choco``)::

    comm key  = fold_in(fold_in(rng, round_idx), 1)
    step key  = fold_in(comm key, t)            t = gossip step in the round
    node key  = fold_in(step key, i)            i = node
    leaf keys = split(node key, n_leaves)       leaves in sorted-name order

and each compressor draws ``uniform(leaf key, shape)``. A torch generator
cannot reproduce threefry's bits, so the port asks one object instead::

    draws.uniform(round_idx, step, leaf, shape) -> float32 [N, *shape]

on the leaf's device, one row per node. ``GeneratorDraws`` is the default:
a ``torch.Generator`` reseeded from ``(seed, round_idx, step, leaf index)``
for every draw, so a draw depends on those indices only, never on the
order of calls. ``ReplayDraws`` returns arrays it was given under the same
indices: the tests feed it the reference's own draws, and a CPU run can
replay the draws of a run on the card.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Draws", "GeneratorDraws", "ReplayDraws"]

Key = Tuple[int, int, str]
_M64 = (1 << 64) - 1


class Draws:
    """The seam's interface."""

    def uniform(self, round_idx: int, step: int, leaf: str,
                shape: Sequence[int]) -> torch.Tensor:
        """Uniform [0, 1) float32 of shape ``[N, *shape]`` for gossip step
        ``step`` of round ``round_idx`` and the leaf named ``leaf``."""
        raise NotImplementedError


class GeneratorDraws(Draws):
    """Draws from a ``torch.Generator`` on ``device``, seeded per draw from
    ``(seed, round_idx, step, leaf index)``; the leaf index is the name's
    place in sorted order, as the reference splits its leaf keys."""

    def __init__(self, seed: int, num_nodes: int, leaves: Iterable[str],
                 device="cuda"):
        self.seed = int(seed)
        self.num_nodes = int(num_nodes)
        self.leaves = tuple(sorted(leaves))
        self.device = resolve_device(device)
        self._gen = None

    def _seed_for(self, round_idx: int, step: int, leaf: str) -> int:
        """A 63-bit seed: splitmix64 folded over the four indices."""
        h = 0
        for v in (self.seed, int(round_idx), int(step),
                  self.leaves.index(leaf)):
            h = (h ^ v) + 0x9E3779B97F4A7C15 & _M64
            h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & _M64
            h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _M64
            h ^= h >> 31
        return h >> 1

    def uniform(self, round_idx, step, leaf, shape):
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self._seed_for(round_idx, step, leaf))
        return torch.rand((self.num_nodes, *shape), generator=self._gen,
                          dtype=torch.float32, device=self.device)


class ReplayDraws(Draws):
    """Returns the arrays of ``table``, keyed ``(round_idx, step, leaf)``,
    each ``[N, *shape]``, as float32 tensors on ``device``."""

    def __init__(self, table: Mapping[Key, np.ndarray], device="cuda"):
        self.device = resolve_device(device)
        self.table = {key: torch.as_tensor(np.asarray(a, np.float32))
                      for key, a in table.items()}

    def uniform(self, round_idx, step, leaf, shape):
        key = (int(round_idx), int(step), leaf)
        if key not in self.table:
            raise KeyError(f"no replayed draw for (round, step, leaf) = {key}")
        out = self.table[key]
        if tuple(out.shape[1:]) != tuple(shape):
            raise ValueError(f"replayed draw {key} has shape "
                             f"{tuple(out.shape)}, asked for [N, *{tuple(shape)}]")
        return out.to(self.device)
