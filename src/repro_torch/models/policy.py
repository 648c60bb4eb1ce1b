"""Activation-sharding policy, with the reference's API.

Ported from ``repro.models.policy``. The reference pins the layout of the
residual stream and of flattened-token tensors on a TPU mesh; the port
runs a node's forward and backward whole on one device: the dense engine
stacks every node on one card, the sparse engine gives each rank one
node, and the meshes (``launch.mesh``) shard a node's weights for
storage and the gossip work only, gathering them whole before each local
step: the gossip-fsdp mesh over ``(data, model)`` on one pod
(``core.substrate.MeshSubstrate``) and on each of two pods, a node a pod
(``NodeMeshSubstrate``), gossip-dp over ``model``, a node a ``data``
coordinate, or a ``(pod, data)`` pair on two pods. So ranks along
``model`` compute the same step (and, in gossip-fsdp, each ``data``
rank the same step on its part of the batch). There is nothing
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
