"""Plain-torch oracles for the port's kernels, written from the reference's
``repro/kernels/ref.py``.

Each kernel function has one oracle here, which the parity harness
(``repro_torch.kernels.registry.parity_suite``) and
``benchmarks/bench_kernels`` hold it against. The oracles are written
apart from the kernel modules' plain versions (``gossip_mix.plain``,
``topk.threshold_plain``, ``choco_fused.plain``, ...), so the harness
compares two functions written apart, as the reference's does. As there,
an oracle treats a whole tensor as one vector (one norm, one k), takes the
same explicit randomness as the kernel (noise tensors), and runs on the
device of its operands. ``torch.topk`` inside ``top_k_ref`` is the
oracle's select, not a port of K4.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["qsgd_ref", "gossip_mix_ref", "choco_move_ref", "top_k_ref",
           "choco_qsgd_ref", "choco_topk_ref"]


def qsgd_ref(x: torch.Tensor, noise: torch.Tensor, *, levels: int,
             c: float) -> torch.Tensor:
    """QSGD of the whole of ``x`` with explicit uniform ``noise`` of its
    shape: ``sign(x) norm floor(s |x| / norm + noise) / (s c)`` in f32 with
    ``norm`` the f32 2-norm of x (0 where the norm is 0), cast to x's
    dtype."""
    flat = x.reshape(-1).float()
    s = float(levels)
    norm = torch.linalg.vector_norm(flat)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    lvl = torch.floor(s * flat.abs() / safe + noise.reshape(-1).float())
    # a tensor divisor on x's device: a Python scalar may become a multiply
    q = torch.sign(flat) * safe * lvl / torch.tensor(
        s * c, dtype=torch.float32, device=x.device)
    q = torch.where(norm > 0, q, torch.zeros_like(q))
    return q.reshape(x.shape).to(x.dtype)


def gossip_mix_ref(x: torch.Tensor, neighbors: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """``weights`` [deg + 1] (self, then each neighbour), ``neighbors``
    [deg, *x.shape]: the weighted sum accumulated in f32, cast to x's
    dtype."""
    acc = weights[0] * x.float()
    for j in range(neighbors.shape[0]):
        acc = acc + weights[j + 1] * neighbors[j].float()
    return acc.to(x.dtype)


def choco_move_ref(x: torch.Tensor, y: torch.Tensor, mixed_y: torch.Tensor,
                   gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CHOCO move ``x + gamma (mixed_y - y)`` and the gap ``x_new - y``,
    both in f32 from the f32 ``x_new``, cast to x's dtype."""
    x32, y32, my32 = (t.float() for t in (x, y, mixed_y))
    x_new = x32 + gamma * (my32 - y32)
    return x_new.to(x.dtype), (x_new - y32).to(x.dtype)


def top_k_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """TopK of the whole of ``x``: the threshold is the k-th largest |x| in
    x's dtype, and every entry at least as large is kept (ties
    inclusive)."""
    flat = x.reshape(-1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat, torch.zeros_like(flat))
    return kept.reshape(x.shape)


def choco_qsgd_ref(x: torch.Tensor, y: torch.Tensor, mixed_y: torch.Tensor,
                   gamma: float, noise: torch.Tensor, *, levels: int,
                   c: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused composition the fused QSGD kernel (K2) reproduces: the
    move, ``qsgd_ref`` of the gap materialised in the leaf dtype, then
    ``y + q`` in the leaf dtype. Returns (x_new, y_new)."""
    x_new, diff = choco_move_ref(x, y, mixed_y, gamma)
    q = qsgd_ref(diff, noise, levels=levels, c=c)
    return x_new, y + q


def choco_topk_ref(x: torch.Tensor, y: torch.Tensor, mixed_y: torch.Tensor,
                   gamma: float, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused composition the fused TopK kernel (K3) reproduces: the
    move, ``top_k_ref`` of the gap in the leaf dtype, then ``y + q``.
    Returns (x_new, y_new)."""
    x_new, diff = choco_move_ref(x, y, mixed_y, gamma)
    q = top_k_ref(diff, k)
    return x_new, y + q
