"""Federated non-IID dataset partitioners (the paper's statistical
heterogeneity setup, Sec. VI-A).

A copy of ``repro.data.federated``, which is numpy-only: the port imports nothing
of the JAX package, so the same seed gives the same bytes here."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray, num_nodes: int, alpha: float, seed: int = 0
) -> List[np.ndarray]:
    """Partition sample indices across nodes with Dirichlet(alpha) class
    proportions per node (small alpha = highly non-IID)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    node_indices: List[List[int]] = [[] for _ in range(num_nodes)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_nodes, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for node, part in enumerate(np.split(idx, cuts)):
            node_indices[node].extend(part.tolist())
    out = []
    for node in range(num_nodes):
        arr = np.asarray(node_indices[node], np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def label_shard_partition(
    labels: np.ndarray, num_nodes: int, shards_per_node: int = 2, seed: int = 0
) -> List[np.ndarray]:
    """McMahan-style pathological non-IID: sort by label, split into
    num_nodes*shards_per_node shards, deal shards to nodes."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, num_nodes * shards_per_node)
    shard_ids = rng.permutation(len(shards))
    out = []
    for node in range(num_nodes):
        take = shard_ids[node * shards_per_node:(node + 1) * shards_per_node]
        idx = np.concatenate([shards[s] for s in take])
        rng.shuffle(idx)
        out.append(idx)
    return out
