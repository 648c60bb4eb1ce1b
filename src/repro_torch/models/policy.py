"""Activation-sharding policy, with the reference's API.

Ported from ``repro.models.policy``. The reference pins the layout of the
residual stream and of flattened-token tensors on a TPU mesh; the port
holds every node of a run on one card, so there is nothing to shard:
``activation_sharding`` is a context that sets nothing, and
``shard_hidden`` / ``shard_tokens`` return their argument.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["activation_sharding", "shard_hidden", "shard_tokens"]


@contextlib.contextmanager
def activation_sharding(mesh=None, *, batch=None, seq=None, embed=None):
    """The reference's policy context; on one card it constrains nothing."""
    del mesh, batch, seq, embed
    yield


def shard_hidden(h: torch.Tensor) -> torch.Tensor:
    """The residual stream [B, S, D], unchanged."""
    return h


def shard_tokens(x: torch.Tensor) -> torch.Tensor:
    """A flattened-token tensor [T, ...], unchanged."""
    return x
