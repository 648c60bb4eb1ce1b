"""Synthetic image-classification datasets standing in for MNIST / CIFAR-10.

A copy of ``repro.data.images``, which is numpy-only: the port imports nothing
of the JAX package, so the same seed gives the same bytes here.

The container is offline, so the paper-reproduction experiments (Figs 7-10)
train the paper's CNNs on generated datasets with the same tensor geometry
(28x28x1 "mnist-like", 32x32x3 "cifar-like") and honest difficulty: each
class is a smooth random template field plus per-sample elastic-ish jitter
and noise, giving a task a small CNN can learn but not trivially.
EXPERIMENTS.md states claims are validated qualitatively on these stand-ins.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.data.federated import dirichlet_partition, label_shard_partition


def _smooth_field(rng: np.random.Generator, h: int, w: int, c: int,
                  cutoff: int = 6) -> np.ndarray:
    """Low-frequency random field via truncated DCT-like mixing."""
    coef = rng.normal(size=(cutoff, cutoff, c))
    ys = np.linspace(0, np.pi, h)[:, None]
    xs = np.linspace(0, np.pi, w)[None, :]
    field = np.zeros((h, w, c))
    for i in range(cutoff):
        for j in range(cutoff):
            basis = np.cos(i * ys) * np.cos(j * xs)
            field += basis[..., None] * coef[i, j]
    field -= field.mean()
    field /= (np.abs(field).max() + 1e-9)
    return field.astype(np.float32)


@dataclasses.dataclass
class SyntheticImages:
    """num_classes templated images; 'mnist' (28x28x1) or 'cifar' (32x32x3)."""

    flavor: str = "mnist"
    num_classes: int = 10
    train_size: int = 10_000
    test_size: int = 2_000
    noise: float = 0.9
    seed: int = 0

    def __post_init__(self):
        h, w, c = (28, 28, 1) if self.flavor == "mnist" else (32, 32, 3)
        self.shape = (h, w, c)
        rng = np.random.default_rng(self.seed)
        self._templates = np.stack(
            [_smooth_field(rng, h, w, c) for _ in range(self.num_classes)])
        self.train_x, self.train_y = self._gen(rng, self.train_size)
        self.test_x, self.test_y = self._gen(rng, self.test_size)

    def _gen(self, rng: np.random.Generator, n: int):
        h, w, c = self.shape
        y = rng.integers(0, self.num_classes, size=n)
        x = self._templates[y].copy()
        # per-sample global shift + amplitude jitter + pixel noise
        amp = rng.uniform(0.5, 1.5, size=(n, 1, 1, 1)).astype(np.float32)
        x *= amp
        shifts = rng.integers(-4, 5, size=(n, 2))
        for i in range(n):  # cheap roll-based jitter
            x[i] = np.roll(x[i], shifts[i], axis=(0, 1))
        x += rng.normal(scale=self.noise, size=x.shape).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    def partition(self, num_nodes: int, scheme: str = "dirichlet",
                  alpha: float = 0.3, seed: int = 0) -> List[np.ndarray]:
        if scheme == "dirichlet":
            return dirichlet_partition(self.train_y, num_nodes, alpha, seed)
        if scheme == "label_shard":
            return label_shard_partition(self.train_y, num_nodes, seed=seed)
        if scheme == "iid":
            rng = np.random.default_rng(seed)
            idx = rng.permutation(len(self.train_y))
            return [np.asarray(p) for p in np.array_split(idx, num_nodes)]
        raise ValueError(f"unknown scheme {scheme!r}")


def image_batches_for_dfl(
    data: SyntheticImages,
    parts: List[np.ndarray],
    tau1: int,
    batch_per_node: int,
    round_idx: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mini-batches [tau1, N, B, H, W, C] / labels [tau1, N, B] for a round."""
    n_nodes = len(parts)
    h, w, c = data.shape
    xs = np.empty((tau1, n_nodes, batch_per_node, h, w, c), np.float32)
    ys = np.empty((tau1, n_nodes, batch_per_node), np.int32)
    for node, idx in enumerate(parts):
        rng = np.random.default_rng(seed * 7919 + node * 101 + round_idx)
        for t in range(tau1):
            take = rng.choice(idx, size=batch_per_node, replace=True)
            xs[t, node] = data.train_x[take]
            ys[t, node] = data.train_y[take]
    return xs, ys
