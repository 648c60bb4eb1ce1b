"""Synthetic language-modeling corpus with learnable structure.

The container is offline, so LM examples/benches train on a synthetic
corpus with real statistical structure (a sampled order-2 Markov chain over
the vocabulary): losses decrease with training and differ measurably across
non-IID shards, which is what the DFL experiments need. Deterministic given
the seed.

Copied from ``repro.data.lm`` as numpy: the tokens are bitwise the
reference's in the eager and the lazy mode, and the batch builders return
numpy int32 arrays with the reference's values, which the executor copies
to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Order-2 Markov-chain corpus, optionally non-IID across nodes.

    Non-IID scheme: each node gets its own transition-matrix mixture
    (alpha -> 1 means nodes nearly disjoint distributions), modelling the
    statistical heterogeneity the paper simulates (Sec. VI-A).
    """

    vocab_size: int
    num_nodes: int = 1
    noniid_alpha: float = 0.5
    branching: int = 16
    seed: int = 0
    # lazy=True is the mega-scale mode (--virtual-nodes): per-node chains
    # are built on first use from np.random.SeedSequence([seed, node]) —
    # a pure function of (seed, node), so shard content is independent of
    # CONSTRUCTION and ACCESS order (a 1M-node corpus costs O(cohort)
    # memory, and prefetcher threading cannot reorder shards). The eager
    # default draws every chain sequentially from one seed stream and is
    # kept bit-identical for existing runs; the two modes intentionally
    # produce different shards.
    lazy: bool = False

    def __post_init__(self):
        v, k = self.vocab_size, min(self.branching, self.vocab_size)

        # shared backbone chain + per-node perturbation chains.
        def chain(rng):
            nxt = rng.integers(0, v, size=(v, k))
            logits = rng.normal(size=(v, k)).astype(np.float32)
            probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
            return nxt, np.cumsum(probs, axis=-1)

        self._chain = chain
        if self.lazy:
            self._shared = chain(np.random.default_rng(
                np.random.SeedSequence([self.seed, self.num_nodes])))
            self._per_node_cache: Dict[int, Tuple[np.ndarray,
                                                  np.ndarray]] = {}
        else:
            rng = np.random.default_rng(self.seed)
            self._shared = chain(rng)
            self._per_node = [chain(rng) for _ in range(self.num_nodes)]

    def _node_chain(self, node: int) -> Tuple[np.ndarray, np.ndarray]:
        node = node % self.num_nodes
        if not self.lazy:
            return self._per_node[node]
        hit = self._per_node_cache.get(node)
        if hit is None:
            hit = self._chain(np.random.default_rng(
                np.random.SeedSequence([self.seed, node])))
            self._per_node_cache[node] = hit
        return hit

    def _sample_stream(self, rng: np.random.Generator, node: int,
                       length: int) -> np.ndarray:
        v = self.vocab_size
        out = np.empty(length, np.int64)
        cur = int(rng.integers(0, v))
        s_nxt, s_cum = self._shared
        n_nxt, n_cum = self._node_chain(node)
        use_node = rng.random(length) < self.noniid_alpha
        u = rng.random(length)
        for i in range(length):
            nxt, cum = (n_nxt, n_cum) if use_node[i] else (s_nxt, s_cum)
            j = int(np.searchsorted(cum[cur], u[i]))
            cur = int(nxt[cur, min(j, nxt.shape[1] - 1)])
            out[i] = cur
        return out

    def batch(self, node: int, batch_size: int, seq_len: int,
              step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + node * 101 + step) % (2**63))
        stream = self._sample_stream(rng, node, batch_size * (seq_len + 1))
        arr = stream.reshape(batch_size, seq_len + 1)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}


def lm_batches_for_dfl(
    corpus: SyntheticLM,
    tau1: int,
    num_nodes: int,
    batch_per_node: int,
    seq_len: int,
    round_idx: int,
) -> Dict[str, np.ndarray]:
    """Batches shaped [tau1, N, B, S] for one DFL round."""
    toks = np.empty((tau1, num_nodes, batch_per_node, seq_len), np.int32)
    labs = np.empty_like(toks)
    for t in range(tau1):
        for n in range(num_nodes):
            b = corpus.batch(n, batch_per_node, seq_len,
                             step=round_idx * tau1 + t)
            toks[t, n] = b["tokens"]
            labs[t, n] = b["labels"]
    return {"tokens": toks, "labels": labs}


def lm_batches_for_cohort(
    corpus: SyntheticLM,
    tau1: int,
    cohort_ids: np.ndarray,
    batch_per_node: int,
    seq_len: int,
    round_idx: int,
) -> Dict[str, np.ndarray]:
    """Batches shaped [tau1, C, B, S] for one batched-engine round.

    Cohort slot j streams the shard of GLOBAL virtual node
    ``cohort_ids[j]`` — the same ``corpus.batch(node, ..., step)`` pure
    function ``lm_batches_for_dfl`` uses, so the slot's data depends only
    on (seed, global node id, step), never on which cohort it was drawn
    into (the shard-order pinning property: tests/test_determinism.py).
    """
    ids = np.asarray(cohort_ids, dtype=np.int64)
    if ids.ndim != 1:
        raise ValueError(f"cohort_ids must be 1-D, got shape {ids.shape}")
    c = ids.shape[0]
    toks = np.empty((tau1, c, batch_per_node, seq_len), np.int32)
    labs = np.empty_like(toks)
    for t in range(tau1):
        for j, n in enumerate(ids):
            b = corpus.batch(int(n), batch_per_node, seq_len,
                             step=round_idx * tau1 + t)
            toks[t, j] = b["tokens"]
            labs[t, j] = b["labels"]
    return {"tokens": toks, "labels": labs}
