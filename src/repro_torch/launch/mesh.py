"""Meshes of ranks: the port's ``repro.launch.mesh``.

The reference lays its devices out as a ``jax.make_mesh`` of named axes,
``("data", "model")`` on one pod and ``("pod", "data", "model")`` on two.
The port lays out the ranks of a ``torch.distributed`` process group the
same way: row-major, the last axis fastest, so rank r of a (data, model)
mesh sits at ``(r // model, r % model)`` and rank r of a (pod, data,
model) mesh at ``(r // (data * model), (r // model) % data, r % model)``.
A ``Mesh`` carries the axes' sizes (``shape``, a dict, and
``axis_names``, as the reference's), this rank's place (``rank``,
``coords``) and one process group for each set of axes: the ranks that
differ only along those axes (``group_of(axes)``), which is what a
collective over a leaf's sharded axes, or over the node axes, runs on
(``core.sharded.ShardGroup``).

``make_production_mesh`` builds the reference's 16 x 16 (or 2 x 16 x 16)
layout with no process group and no rank: it feeds the placement rules
(``launch.sharding``) and nothing runs on it. The card's peak rates live
in ``launch.roofline``, not here.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

__all__ = ["Mesh", "make_host_mesh", "make_production_mesh"]


class Mesh:
    """Named axes over ranks laid out row-major (``shape``: axis -> size,
    in order). ``rank`` (None without one) is this process's place in the
    mesh, ``coords`` its index along each axis; ``group`` the process group
    the mesh spans (None: the default group, or no group at all for a mesh
    of one rank or a production mesh that runs nothing)."""

    def __init__(self, shape: Dict[str, int], rank: Optional[int] = None,
                 group=None, global_ranks: Optional[Sequence[int]] = None):
        self.shape = {str(a): int(s) for a, s in shape.items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.rank = None if rank is None else int(rank)
        self.group = group
        self.global_ranks = (list(range(self.size)) if global_ranks is None
                             else [int(r) for r in global_ranks])
        self.coords = (None if self.rank is None
                       else self.coords_of(self.rank))
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The row-major coordinates of mesh rank ``rank``."""
        out, rest = {}, int(rank)
        for axis in reversed(self.axis_names):
            rest, out[axis] = divmod(rest, self.shape[axis])
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for axis in self.axis_names:
            rank = rank * self.shape[axis] + int(coords[axis])
        return rank

    def axes_in_order(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """``axes`` that the mesh has, in the mesh's order."""
        return tuple(a for a in self.axis_names if a in set(axes))

    def axes_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in self.axes_in_order(axes)],
                           dtype=np.int64))

    def members(self, axes: Sequence[str],
                rank: Optional[int] = None) -> List[int]:
        """The mesh ranks that share ``rank``'s coordinates on every axis
        but ``axes``, ascending (which is row-major over ``axes``)."""
        me = self.coords_of(self.rank if rank is None else rank)
        axes = self.axes_in_order(axes)
        out = []
        for idx in itertools.product(*[range(self.shape[a]) for a in axes]):
            c = dict(me)
            c.update(zip(axes, idx))
            out.append(self.rank_of(c))
        return sorted(out)

    def group_of(self, axes: Sequence[str]) -> Tuple[object, int]:
        """(process group, size) of the ranks that differ from this one only
        along ``axes``; (None, 1) when that is this rank alone."""
        key = self.axes_in_order(axes)
        size = self.axes_size(key)
        if size == 1:
            return None, 1
        if key not in self._groups:
            raise ValueError(f"no process group for the axes {key}: this "
                             "mesh has no ranks (a production mesh) or was "
                             "not made by make_host_mesh")
        return self._groups[key][0], size

    def _make_groups(self) -> None:
        """One process group for every set of axes and every set of ranks
        along it; every rank makes every group, in the same order (what
        ``torch.distributed.new_group`` requires)."""
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                if self.axes_size(axes) == 1:
                    continue
                seen = set()
                for r in range(self.size):
                    ranks = tuple(self.members(axes, r))
                    if ranks in seen:
                        continue
                    seen.add(ranks)
                    pg = dist.new_group([self.global_ranks[m] for m in ranks])
                    if self.rank in ranks:
                        self._groups[axes] = (pg, list(ranks))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_host_mesh(data: int = 1, model: int = 1, group=None, *,
                   pod: Optional[int] = None) -> Mesh:
    """A ``(data, model)`` mesh over the ranks of ``group`` (the default
    process group when None), or with ``pod`` given a ``(pod, data,
    model)`` one, row-major as ``jax.make_mesh`` lays devices out: rank r
    of a pod mesh sits at ``(r // (data * model), (r // model) % data, r %
    model)``. ``pod=1`` is a real axis of size 1, as the reference treats
    one (gossip-fsdp then has one node, the pod). The reference cuts the
    axes to the devices there are; here a mesh that does not cover the
    group's ranks exactly raises, since a rank outside it would wait on
    collectives it never joins and a smaller mesh would run as if it were
    the one asked for. Without an initialised process group only a mesh
    of one rank (this process alone) can be made."""
    sizes = {"data": int(data), "model": int(model)}
    if pod is not None:
        sizes = {"pod": int(pod), **sizes}
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size(group)
        rank = dist.get_rank(group)
        global_ranks = [dist.get_global_rank(group, r) if group is not None
                        else r for r in range(n)]
    elif group is not None:
        raise ValueError("a process group was given but torch.distributed "
                         "is not initialised")
    else:
        n, rank, global_ranks = 1, 0, [0]
    total = int(np.prod(list(sizes.values()), dtype=np.int64))
    if min(sizes.values()) < 1 or total != n:
        raise ValueError(
            f"a {' x '.join(map(str, sizes.values()))} mesh over {n} ranks "
            f"({' x '.join(sizes)}): give {' * '.join(sizes)} == ranks"
            + ("" if n > 1 else " (a mesh of more than one rank needs an "
               "initialised process group)"))
    mesh = Mesh(sizes, rank, group, global_ranks)
    if n > 1:
        mesh._make_groups()
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16 x 16 pod (2 x 16 x 16 over two pods), for the
    placement rules: no process group, no rank."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return Mesh(shape)
