"""Activation-sharding policy, with the reference's API.

Ported from ``repro.models.policy``. The reference pins the layout of the
residual stream and of flattened-token tensors on a TPU mesh; the port
runs a node's forward and backward whole on one device: the dense engine
stacks every node on one card, the sparse engine gives each rank one
node, and the gossip-fsdp mesh (``launch.mesh``, ``core.substrate.
MeshSubstrate``) shards a node's weights over ``(data, model)`` for
storage and the gossip work only, gathering them whole before each local
step, so ranks along ``model`` compute the same step. There is nothing
to shard yet: ``activation_sharding`` is a context that sets nothing, and
``shard_hidden`` / ``shard_tokens`` return their argument. Splitting the
compute over ``model`` (tensor-parallel matmuls, the residual stream
sharded as the reference pins it) is ROADMAP.md queue 1, item 15.
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
