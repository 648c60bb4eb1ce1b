"""Logical-axis -> mesh-axis placement rules: the port's
``repro.launch.sharding``.

Two parameter-placement modes, the reference's:

* ``gossip-dp``  : the DFL node dimension (leading, added by
  ``core.dfl.replicate``) is sharded over the node mesh axes
  (``data`` / ``pod`` + ``data``); weight dims shard over ``model`` only.
* ``gossip-fsdp``: few replicated nodes; weight dims shard over ``model``
  AND ``data`` (FSDP on the embed dim).

A rule is skipped when the dim does not divide by the mesh axis's size, or
when the mesh axis is already used by an earlier dim of the same leaf (a
spec names an axis once); the dim then stays replicated.

A spec is a tuple of one entry a dim, each a mesh-axis name, a tuple of
names or None, equal entry by entry to the reference's ``PartitionSpec``.
On the port's ranks (``launch.mesh.make_host_mesh``) a rank holds the
block of each leaf that its coordinates pick (``shard_leaf``), and the
whole leaf is the all-gather of the blocks (``unshard_leaf``); the
gossip-fsdp round over such blocks is ``core.substrate.MeshSubstrate``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sharded import ShardGroup, take_block

__all__ = ["RULES", "node_axes_for", "num_nodes_for", "spec_for_param",
           "params_specs", "batch_spec", "shard_leaf", "unshard_leaf"]

Spec = Tuple[Any, ...]

# logical axis -> mesh axis, per mode (applied left to right per leaf).
RULES: Dict[str, Dict[str, str]] = {
    "gossip-dp": {
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": "model",
        "experts": "model",
        "ssm_inner": "model",
    },
    "gossip-fsdp": {
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": "model",
        "experts": "model",
        "ssm_inner": "model",
        "embed": "data",
    },
}


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64))


def node_axes_for(mode: str, mesh) -> Tuple[str, ...]:
    """The mesh axes that enumerate DFL nodes."""
    has_pod = "pod" in mesh.axis_names
    if mode == "gossip-dp":
        return ("pod", "data") if has_pod else ("data",)
    if mode == "gossip-fsdp":
        # hierarchical DFL: nodes = pods on the multi-pod mesh, a replicated
        # node dim on a single pod
        return ("pod",) if has_pod else ()
    raise ValueError(mode)


def num_nodes_for(mode: str, mesh, fsdp_nodes: int) -> int:
    axes = node_axes_for(mode, mesh)
    if mode == "gossip-dp" or axes:
        return _axes_size(mesh, axes)
    # gossip-fsdp on a single pod: fsdp_nodes replicated nodes
    return fsdp_nodes


def spec_for_param(logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int], mode: str, mesh,
                   node_dim: bool) -> Spec:
    """The spec of one (possibly node-stacked) parameter leaf."""
    rules = RULES[mode]
    entries = []
    used = set()
    offset = 0
    if node_dim:
        naxes = node_axes_for(mode, mesh)
        if naxes and shape[0] == _axes_size(mesh, tuple(naxes)):
            entries.append(naxes if len(naxes) > 1 else naxes[0])
            used.update(naxes)
        else:
            entries.append(None)
        offset = 1
    # the stacked 'layers' axis (if present) is in logical_axes already
    for i, name in enumerate(logical_axes):
        dim = shape[offset + i]
        mesh_axis = rules.get(name) if name else None
        if (mesh_axis is not None and mesh_axis in mesh.axis_names
                and mesh_axis not in used
                and dim % mesh.shape[mesh_axis] == 0):
            entries.append(mesh_axis)
            used.add(mesh_axis)
        else:
            entries.append(None)
    return tuple(entries)


def params_specs(axes: Dict[str, Tuple], params: Dict[str, Any], mode: str,
                 mesh, node_dim: bool) -> Dict[str, Spec]:
    """The spec of every leaf of a flat parameter dict (``axes``: each
    leaf's logical axes, as ``models.init_params`` returns them; a leaf
    need only have a ``shape``)."""
    return {name: spec_for_param(axes[name], tuple(leaf.shape), mode, mesh,
                                 node_dim)
            for name, leaf in params.items()}


def batch_spec(mesh, mode: str, *, has_tau_dim: bool) -> Spec:
    """DFL training batches ``[tau1?, N, B, ...]``: N over the node axes in
    gossip-dp; B over ``data`` in gossip-fsdp (the node dim replicated)."""
    naxes = node_axes_for(mode, mesh)
    lead = (None,) if has_tau_dim else ()
    if mode == "gossip-dp":
        n_entry = naxes if len(naxes) > 1 else naxes[0]
        return lead + (n_entry, None, None)
    return lead + (naxes[0] if naxes else None, "data", None)


def shard_leaf(whole: torch.Tensor, spec: Spec, mesh,
               coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The block of ``whole`` that the rank at ``coords`` (this one by
    default) holds, contiguous; trailing dims past the spec are whole."""
    return take_block(whole, spec, mesh, coords)


def unshard_leaf(shard: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block, all-gathered over the ranks
    that hold its other blocks (every one of them must call it)."""
    return ShardGroup(mesh, shard.device).gather({"leaf": shard},
                                                 {"leaf": spec})["leaf"]
