"""The sparse engine's process plumbing: one DFL node per process.

``core.dfl.make_round_fn(..., engine="sparse", group=...)`` and
``make_pipeline_fns`` build the sparse engine. The reference runs one
node per device under a ``shard_map`` that is manual over the node mesh
axes; the port runs one node per process of a ``torch.distributed``
group, rank i holding node i's ``[1, ...]`` row of every leaf of the
state and of its batches. The round itself is ``core.dfl.round_body``
(or ``pipeline_round_body``) on a ``ShardedSubstrate``, the same code
the dense engine runs, so the engines cannot drift apart; this module
owns only the group: ``NodeGroup`` (rank, world size, device, backend),
its exchange of the leaves over a shift (``shift_exchange``, deg copies
a gossip step where the dense product reads all N), its sums over ranks
(``all_reduce_sum``), and ``spawn``, which runs a function on N ranks of
a fresh group.

Backends. Under ``nccl`` (a card per rank) the exchange moves device
tensors. Under ``gloo`` it moves host tensors: on the card, each exchange
is copied into pinned host memory, sent, received and copied back,
explicitly, while every kernel runs on the card; N ranks on one card
need gloo (NCCL refuses two ranks on one GPU). The backend is whatever
the caller initialised; nothing switches it on a failure.

Collective matching: every rank makes every shift's send and receive in
every gossip step, masked edges included (masks gate weights, never
traffic), and the dynamic rounds' trip counts are the same host ints on
every rank, so the ranks never wait on a send that is not made.

Selection rule (``core.dfl.check_sparse``, ``sparse_engine_eligible``):
a circulant C, no topology schedule and no ``dense_power``, and a group
of exactly the N > 1 nodes.

The gossip-fsdp mesh (``ShardGroup``, beside ``NodeGroup``) is the other
way to spread a run over ranks: every rank holds every node, each leaf
cut into blocks over the axes of a ``launch.mesh.Mesh`` that its spec
names (``launch.sharding``). ``ShardGroup`` owns the collectives such a
state needs: the all-gather of a leaf over the ranks that hold its
blocks (``gather``), the sum over the ranks that hold distinct parts of
a row (``sum_over``), and the mean of a gradient over the ``data`` ranks,
cut to this rank's block (``reduce_to_shard``). Every one moves the
operands' bytes (an all-gather, or for the gradients a point-to-point
exchange of the blocks each rank keeps) and sums in rank order on the
device, so the result is the same on every rank and in every group,
whatever the backend does inside; under gloo on the card the bytes are
staged through pinned host memory, as ``shift_exchange``'s are. The
block arithmetic (``block_spans``, ``take_block``, ``place_blocks``)
lives here too.

Where the nodes enumerate mesh axes (``node_axes``: gossip-dp's
``("data",)`` on one pod or ``("pod", "data")`` on two, gossip-fsdp's
``("pod",)`` on two pods), ``ShardGroup`` also carries the sparse
engine's exchange: ``shift_exchange`` along the row-major node index
over those axes, among the ranks that share this rank's other
coordinates, each rank sending its block of its node; ``node_rows``,
every node's block gathered for a C that is not circulant; and
``all_reduce_sum``, the sum over the nodes.
"""
from __future__ import annotations

import collections
import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device, share_host_threads

__all__ = ["NodeGroup", "ShardGroup", "RowSpan", "backend_for", "local_rows",
           "pack_layout", "spawn", "entry_axes", "spec_axes", "block_spans",
           "take_block", "place_blocks"]

DATA_AXIS = "data"   # the mesh axis a node's batch is split over

_ALIGN = 16  # bytes: every leaf of a packed exchange starts 16-byte aligned


def pack_layout(leaves: Sequence[torch.Tensor]) -> Tuple[List[int], int]:
    """Where each leaf starts in ``shift_exchange``'s packed byte buffer,
    and the buffer's size: the leaves in order, each padded to a multiple
    of 16 bytes."""
    offsets, total = [], 0
    for x in leaves:
        offsets.append(total)
        total += -(-x.numel() * x.element_size() // _ALIGN) * _ALIGN
    return offsets, total


def _pack(leaves: Sequence[torch.Tensor], device) -> Tuple[torch.Tensor,
                                                          List[int]]:
    """The leaves' bytes in one buffer on ``device`` (``pack_layout``), and
    where each starts."""
    offsets, total = pack_layout(leaves)
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    for x, at in zip(leaves, offsets):
        buf[at:at + x.numel() * x.element_size()].copy_(
            x.reshape(-1).view(torch.uint8))
    return buf, offsets


def _unpacked(buf: torch.Tensor, like: Sequence[torch.Tensor],
              offsets: Sequence[int]) -> List[torch.Tensor]:
    """Views of a packed buffer as tensors shaped as ``like``."""
    return [buf[at:at + t.numel() * t.element_size()].view(t.dtype)
            .view(t.shape) for t, at in zip(like, offsets)]


def _unpacked_rows(buf: torch.Tensor, like: Sequence[torch.Tensor],
                   offsets: Sequence[int]) -> List[torch.Tensor]:
    """Views of the rows of ``[R, packed]`` buffers as ``[R, D]`` flat
    copies of the tensors ``like``."""
    return [buf[:, at:at + t.numel() * t.element_size()].view(t.dtype)
            for t, at in zip(like, offsets)]


class _Staged:
    """A rank's ``device`` and ``backend`` (``gloo`` or ``nccl``, as the
    caller initialised ``torch.distributed``), and the staging that gloo
    needs on the card: ``staged`` when the backend moves host tensors and
    the operands live on a card."""

    def __init__(self, device, backend: Optional[str]):
        self.device = torch.device(device)
        self.backend = backend
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend moves device tensors; give "
                             "the group a CUDA device")
        self.staged = backend == "gloo" and self.device.type == "cuda"
        # seconds the shift exchanges took (host clock, waits for the device
        # included) and the bytes this rank sent in them (the packed buffer,
        # once a shift), for the callers' reports and the roofline's
        # collective term (``launch.roofline``); how many sends it made to
        # each (src, dst) node pair: a host counter, at most one key a
        # shift, for the collective audits (``repro_torch.analysis.audits``)
        self.exchange_s = 0.0
        self.exchange_bytes = 0
        self.sends: collections.Counter = collections.Counter()

    def _staging(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend can move it: a pinned host copy under
        gloo on the card (the device-to-host copy waits for it), else
        ``t``."""
        if not self.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _home(self, t: torch.Tensor) -> torch.Tensor:
        """A staged tensor back on the device. The copy ends before the
        host goes on, so its pinned buffer is free for the next collective
        as soon as it is dropped: a copy still in flight would keep the
        buffer from the host allocator's reuse, and ranks sharing a card
        would pin a new set of buffers at every exchange."""
        return t.to(self.device) if self.staged else t

    def _all_reduce(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``group`` (None: the default
        group) in one all-reduce, a new tensor on ``t``'s device, the same
        bits on every rank of the group."""
        buf = self._staging(t.contiguous())
        if buf is t or buf.data_ptr() == t.data_ptr():
            buf = buf.clone()
        dist.all_reduce(buf, group=group)
        return self._home(buf)

    def _shift_exchange(self, leaves: Sequence[torch.Tensor],
                        shifts: Sequence[int], node: int, world: int,
                        peer: Callable[[int], int]) -> List[torch.Tensor]:
        """The shift exchange of node ``node`` of ``world`` (``peer``: a
        node's global rank): for each shift s the packed ``leaves`` go to
        node (node + s) mod N and node (node - s) mod N's come back, one
        buffer a shift (tagged with the shift's position); returns each
        leaf's ``[len(shifts), D]`` received copies on the device. Counted
        in ``exchange_s``, ``exchange_bytes`` and ``sends`` (under the
        node pair)."""
        t0 = time.perf_counter()
        send, offsets = _pack(leaves, self.device)
        total = send.numel()
        send = self._staging(send)
        recv = torch.empty((len(shifts), total), dtype=torch.uint8,
                           device=send.device, pin_memory=self.staged)
        ops = []
        for j, s in enumerate(shifts):
            dst = (node + s) % world
            ops.append(dist.P2POp(dist.isend, send, peer(dst), tag=j))
            self.sends[(node, dst)] += 1
            ops.append(dist.P2POp(dist.irecv, recv[j],
                                  peer((node - s) % world), tag=j))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        recv = self._home(recv)
        self.exchange_s += time.perf_counter() - t0
        self.exchange_bytes += total * len(shifts)
        return _unpacked_rows(recv, leaves, offsets)


class NodeGroup(_Staged):
    """This process's place in the node group: ``rank`` (the node it
    holds), ``world`` (the number of nodes), ``device`` (where its leaves
    and kernels live) and ``backend`` (``gloo`` or ``nccl``, as the caller
    initialised ``torch.distributed``)."""

    def __init__(self, rank: int, world: int, device, backend: str):
        super().__init__(device, backend)
        self.rank, self.world = int(rank), int(world)

    @classmethod
    def current(cls, device) -> "NodeGroup":
        """The group of the initialised default process group."""
        if not dist.is_initialized():
            raise ValueError("torch.distributed is not initialised: the "
                             "sparse engine runs one rank per node")
        return cls(dist.get_rank(), dist.get_world_size(), device,
                   dist.get_backend())

    def shift_exchange(self, leaves: Sequence[torch.Tensor],
                       shifts: Sequence[int]) -> List[torch.Tensor]:
        """Send this node's flat ``leaves`` to rank (r + s) mod N and
        receive rank (r - s) mod N's, for each shift s; returns, for each
        leaf, its ``[len(shifts), D]`` received copies (row j from shift
        j's sender), in the leaf's dtype on the group's device. The tree
        travels as one packed byte buffer a shift, each leaf 16-byte
        aligned in it. Each send is counted in ``sends`` under its
        (src, dst) and its bytes added to ``exchange_bytes``."""
        return self._shift_exchange(leaves, shifts, self.rank, self.world,
                                    lambda node: node)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, a new tensor on ``t``'s
        device."""
        return self._all_reduce(t)

    def gather_rows(self, tree: Any) -> Any:
        """The ``[N, ...]`` stack of every rank's ``[1, ...]`` leaves of
        ``tree`` (on every rank, on the group's device): what a checkpoint
        of the sparse engine writes."""
        def one(x):
            mine = self._staging(x.contiguous())
            parts = [torch.empty_like(mine) for _ in range(self.world)]
            dist.all_gather(parts, mine)
            return self._home(torch.cat(parts))
        return tree_map(one, tree)


# ---------------------------------------------------------------------------
# The gossip-fsdp mesh: blocks of a leaf and the collectives over them
# ---------------------------------------------------------------------------

Spec = Tuple[Any, ...]   # one mesh-axis entry a dim: None, a name, or names


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in the entry's order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """Every mesh axis that ``spec`` names, in the mesh's order: the ranks
    that differ along them hold the distinct blocks of the leaf."""
    named = [a for e in spec for a in entry_axes(e)]
    return mesh.axes_in_order(named)


def block_spans(shape: Sequence[int], spec: Spec, mesh,
                coords: Optional[Dict[str, int]] = None
                ) -> Tuple[Tuple[int, int], ...]:
    """(start, size) along each dim of a leaf of ``shape`` of the block
    held at ``coords`` (this rank's by default): a dim whose entry names
    axes is cut into as many equal blocks as those axes have ranks, the
    block's index row-major over them in the entry's order."""
    coords = mesh.coords if coords is None else coords
    spans = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        idx, count = 0, 1
        for axis in entry_axes(entry):
            idx = idx * mesh.shape[axis] + int(coords[axis])
            count *= mesh.shape[axis]
        if dim % count:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide into "
                             f"{count} blocks (spec {spec})")
        size = dim // count
        spans.append((idx * size, size))
    return tuple(spans)


def take_block(whole: torch.Tensor, spec: Spec, mesh,
               coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The block of ``whole`` held at ``coords`` (``block_spans``), a
    contiguous tensor; ``whole`` itself when the block is all of it."""
    spans = block_spans(whole.shape, spec, mesh, coords)
    if all(size == dim for (_, size), dim in zip(spans, whole.shape)):
        return whole
    out = whole
    for i, (start, size) in enumerate(spans):
        if size != whole.shape[i]:
            out = out.narrow(i, start, size)
    return out.contiguous()


def place_blocks(blocks: Sequence[torch.Tensor], spec: Spec, mesh,
                 axes: Sequence[str]) -> torch.Tensor:
    """The whole leaf from its blocks, ``blocks[j]`` the block of the j-th
    rank, row-major over ``axes`` (mesh order), of the ranks that share
    this rank's other coordinates."""
    axes = mesh.axes_in_order(axes)
    if len(blocks) == 1:
        return blocks[0]
    first = blocks[0]
    counts = []
    for i in range(first.dim()):
        entry = spec[i] if i < len(spec) else None
        counts.append(int(np.prod([mesh.shape[a] for a in entry_axes(entry)],
                                  dtype=np.int64)))
    whole = first.new_empty([d * c for d, c in zip(first.shape, counts)])
    for j, block in enumerate(blocks):
        coords = dict(mesh.coords)
        rest = j
        for axis in reversed(axes):
            rest, coords[axis] = divmod(rest, mesh.shape[axis])
        view = whole
        for i, (start, size) in enumerate(block_spans(whole.shape, spec,
                                                      mesh, coords)):
            view = view.narrow(i, start, size)
        view.copy_(block)
    return whole


class RowSpan:
    """The ranks over which the rows of some leaves are split: ``size``
    of them, ``sum(t)`` adds a tensor over them (in rank order, the same
    result on each), ``gather_cols(x)`` puts a ``[R, D_part]`` part's
    rows back together as ``[R, size * D_part]`` (the parts side by side,
    which is the whole row up to the order of its elements)."""

    def __init__(self, group: "ShardGroup", axes: Tuple[str, ...]):
        self.group, self.axes = group, axes
        self.size = group.mesh.axes_size(axes)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.group.sum_over(t, self.axes)

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        parts = self.group.all_gather(x.contiguous(), self.axes)
        return torch.cat(parts, dim=1) if len(parts) > 1 else x


class ShardGroup(_Staged):
    """This rank's collectives on a gossip-fsdp mesh (``launch.mesh.Mesh``,
    over an initialised process group, or a mesh of one rank without
    one): every operand travels as its bytes in one all-gather over the
    ranks of the axes in question (the gradients' reduction: one
    point-to-point exchange of the blocks each data rank keeps), and
    whatever is summed is summed after it, in rank order, on ``device``.
    Under gloo on the card the bytes go through pinned host memory,
    explicitly; under nccl device tensors move as they are; nothing
    switches backend on a failure. Every rank must make every collective
    in the same order.

    ``node_axes``: the mesh axes the nodes enumerate, in the mesh's order
    (``launch.sharding.node_axes_for`` of the mode and the mesh; gossip-dp
    on one pod's ``("data",)`` by default), over which ``shift_exchange``,
    ``node_rows`` and ``all_reduce_sum`` act; node j is the rank with this
    rank's other coordinates and the j-th row-major coordinates on them.

    Counters for the callers' reports (host clock, waits for the device
    included): ``collective_s`` in all collectives but the shift exchange,
    ``gathered_bytes`` received by ``gather``, ``reduced_bytes`` received
    by the sums and ``reduce_to_shard``; the shift exchange's
    ``exchange_s``, ``exchange_bytes`` and ``sends``, as ``NodeGroup``'s
    (``sends`` in node indices)."""

    def __init__(self, mesh, device, backend: Optional[str] = None,
                 node_axes: Sequence[str] = (DATA_AXIS,)):
        if mesh.rank is None:
            raise ValueError(
                f"no process group: the mesh {mesh.shape} has no ranks (a "
                "production mesh feeds the placement rules only); make one "
                "with launch.mesh.make_host_mesh")
        if backend is None and mesh.size > 1:
            backend = dist.get_backend(mesh.group)
        super().__init__(device, backend)
        self.mesh = mesh
        self.node_axes = mesh.axes_in_order(node_axes)
        # the mesh ranks of nodes 0 .. N-1 (ascending rank is row-major
        # over the node axes), and this rank's node
        self._nodes = mesh.members(self.node_axes)
        self.collective_s = 0.0
        self.gathered_bytes = 0
        self.reduced_bytes = 0

    @property
    def num_nodes(self) -> int:
        return len(self._nodes)

    def node_index(self) -> int:
        """This rank's node: its row-major index over the node axes."""
        return self._nodes.index(self.mesh.rank)

    def span(self, axes: Sequence[str]) -> RowSpan:
        return RowSpan(self, self.mesh.axes_in_order(axes))

    def all_gather_many(self, ts: Sequence[torch.Tensor],
                        axes: Sequence[str]) -> List[List[torch.Tensor]]:
        """Every rank's tensors ``ts`` (the same shapes and dtypes on all)
        over the ranks that differ from this one along ``axes``, in one
        all-gather of their packed bytes (``pack_layout``): ``out[j][i]``
        is the j-th rank's ``ts[i]``; ``[ts]`` alone when there are none."""
        ts = list(ts)
        pg, size = self.mesh.group_of(axes)
        if size == 1:
            return [ts]
        t0 = time.perf_counter()
        send, offsets = _pack(ts, ts[0].device)
        send = self._staging(send)
        recv = torch.empty(size * send.numel(), dtype=torch.uint8,
                           device=send.device, pin_memory=self.staged)
        dist.all_gather(list(recv.chunk(size)), send, group=pg)
        recv = self._home(recv)
        self.collective_s += time.perf_counter() - t0
        return [_unpacked(chunk, ts, offsets) for chunk in recv.chunk(size)]

    def all_gather(self, t: torch.Tensor, axes: Sequence[str]
                   ) -> List[torch.Tensor]:
        """Every rank's ``t`` over the ranks of ``axes``, in their order."""
        return [got[0] for got in self.all_gather_many([t], axes)]

    def shift_exchange(self, leaves: Sequence[torch.Tensor],
                       shifts: Sequence[int]) -> List[torch.Tensor]:
        """``NodeGroup.shift_exchange`` over the node axes: for each shift s
        this rank's packed ``leaves`` go to node (i + s) mod N's rank with
        this rank's other coordinates (i this rank's node), and node
        (i - s) mod N's come back; returns each leaf's ``[len(shifts), D]``
        received copies. ``sends`` counts the (src, dst) node indices, so
        the ranks of one set of other coordinates together hold what the
        sparse engine's ranks would
        (``analysis.audits.expected_shift_pairs``)."""
        nodes, ranks = self._nodes, self.mesh.global_ranks
        return self._shift_exchange(leaves, shifts, self.node_index(),
                                    len(nodes), lambda j: ranks[nodes[j]])

    def node_rows(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every node's copy of this rank's ``[1, ...]`` ``leaves`` (the
        ranks that differ only along the node axes), stacked ``[N, ...]``
        in node order, in one all-gather: what a gossip step over a C that
        is not circulant reads. The bytes this rank sent to the others
        count in ``exchange_bytes``."""
        got = self.all_gather_many(leaves, self.node_axes)
        self.exchange_bytes += (len(got) - 1) * sum(
            x.numel() * x.element_size() for x in leaves)
        if len(got) == 1:
            return list(leaves)
        return [torch.cat([g[i] for g in got]) for i in range(len(leaves))]

    @staticmethod
    def _received(blocks: List[torch.Tensor]) -> int:
        """Bytes an all-gather of ``blocks`` brought in from other ranks."""
        return (len(blocks) - 1) * blocks[0].numel() * blocks[0].element_size()

    @staticmethod
    def _summed(blocks: List[torch.Tensor]) -> torch.Tensor:
        out = blocks[0].clone()
        for b in blocks[1:]:
            out += b
        return out

    def sum_over(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """``t`` summed over the ranks of ``axes``, in rank order (``t``
        itself where there is one rank)."""
        blocks = self.all_gather(t, axes)
        if len(blocks) == 1:
            return t
        self.reduced_bytes += self._received(blocks)
        return self._summed(blocks)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the nodes (the ranks that differ only along
        the node axes) in one all-reduce (``t`` itself where there is one
        node): the same bits on every rank of the group, in the backend's
        order of the sum; ``NodeGroup.all_reduce_sum`` on a mesh of nodes,
        where ``sum_over``'s all-gather would bring every node's block to
        every rank."""
        pg, size = self.mesh.group_of(self.node_axes)
        if size == 1:
            return t
        t0 = time.perf_counter()
        out = self._all_reduce(t, pg)
        self.collective_s += time.perf_counter() - t0
        self.reduced_bytes += t.numel() * t.element_size()
        return out

    def mean_over(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The mean of ``t`` over the ranks of ``axes``, summed in f32 in
        rank order and cast back (``t`` itself where there is one rank)."""
        blocks = self.all_gather(t, axes)
        if len(blocks) == 1:
            return t
        self.reduced_bytes += self._received(blocks)
        return (self._summed([b.float() for b in blocks])
                / len(blocks)).to(t.dtype)

    def gather(self, xs: Dict[str, torch.Tensor],
               specs: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
        """The whole leaves of this rank's blocks ``xs`` (any leading dims
        their specs leave unsharded, such as a chunk of nodes): one
        all-gather for the leaves of each set of axes their specs name."""
        out = dict(xs)
        for axes, names in _by_axes(xs, specs, self.mesh).items():
            got = self.all_gather_many([xs[n] for n in names], axes)
            if len(got) == 1:
                continue
            for i, name in enumerate(names):
                blocks = [g[i] for g in got]
                self.gathered_bytes += self._received(blocks)
                out[name] = place_blocks(blocks, specs[name], self.mesh, axes)
        return out

    def exchange(self, sends: Dict[int, List[torch.Tensor]]
                 ) -> Dict[int, List[torch.Tensor]]:
        """Point to point: ``sends[m]`` goes to mesh rank m (one packed
        buffer a peer, staged as ``all_gather_many``'s), for every m in
        ``sends`` but this rank, and each such m's tensors for this rank
        come back, shaped as ``sends[self.mesh.rank]`` (every rank sends
        blocks of one shape). Every rank named must call it alike."""
        me = self.mesh.rank
        like = sends[me]
        peers = [m for m in sends if m != me]
        if not peers:
            return {me: like}
        t0 = time.perf_counter()
        ops_, recvs = [], {}
        for m in peers:
            buf, offsets = _pack(sends[m], like[0].device)
            buf = self._staging(buf)
            recvs[m] = torch.empty(buf.shape, dtype=torch.uint8,
                                   device=buf.device, pin_memory=self.staged)
            peer = self.mesh.global_ranks[m]
            ops_.append(dist.P2POp(dist.isend, buf, peer))
            ops_.append(dist.P2POp(dist.irecv, recvs[m], peer))
        for req in dist.batch_isend_irecv(ops_):
            req.wait()
        out = {me: like}
        for m, buf in recvs.items():
            out[m] = _unpacked(self._home(buf), like, offsets)
        self.collective_s += time.perf_counter() - t0
        return out

    def reduce_to_shard(self, gs: Dict[str, torch.Tensor],
                        specs: Dict[str, Spec],
                        axes: Sequence[str] = (DATA_AXIS,)
                        ) -> Dict[str, torch.Tensor]:
        """This rank's block of the mean over the ranks of ``axes`` (the
        axes a node's batch is split over: ``data``) of each whole ``gs``
        leaf (each such rank's gradient of its part of the batch): every
        leaf is cut to the block of each rank of the group (the ranks
        differ only along ``axes``), each rank sends the others their
        blocks in one exchange, and sums what it holds in f32 in rank
        order, divides and casts back: what an all-reduce and a cut would
        give, at (group - 1) / group of the leaves' part on the wire in
        place of all of it. With no such axis (``axes=()``: a node's batch
        whole on the rank) it is this rank's block of each leaf."""
        names = list(gs)
        members = self.mesh.members(axes)
        sends = {m: [] for m in members}
        for name in names:
            g = gs.pop(name)
            for m in members:
                sends[m].append(take_block(g, specs[name], self.mesh,
                                           self.mesh.coords_of(m)))
            del g
        if len(members) == 1:
            return dict(zip(names, sends[members[0]]))
        got = self.exchange(sends)
        mine = got[self.mesh.rank]
        self.reduced_bytes += sum(t.numel() * t.element_size()
                                  for t in mine) * (len(members) - 1)
        return {name: (self._summed([got[m][i].float() for m in members])
                       / len(members)).to(mine[i].dtype)
                for i, name in enumerate(names)}


def _by_axes(xs, specs, mesh) -> Dict[Tuple[str, ...], List[str]]:
    """The names of ``xs`` grouped by the mesh axes their specs name, in
    first-seen order (the same on every rank)."""
    out: Dict[Tuple[str, ...], List[str]] = {}
    for name in xs:
        out.setdefault(spec_axes(specs[name], mesh), []).append(name)
    return out


def backend_for(device, ranks_on_host: int) -> str:
    """The group's backend: nccl when every rank on the host has a card of
    its own, else gloo (the CPU, or ranks sharing a card: NCCL refuses two
    ranks on one GPU)."""
    if (torch.device(device).type == "cuda"
            and ranks_on_host <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def local_rows(tree: Any, group: NodeGroup, axis: int = 0) -> Any:
    """This rank's ``[..., 1, ...]`` slice of a tree stacked over all N
    nodes along ``axis`` (batches ``[tau1, N, ...]``: ``axis=1``)."""
    return tree_map(lambda x: x.narrow(axis, group.rank, 1), tree)


def _rank_main(rank: int, world: int, store: str, backend: str, device: str,
               timeout_s: float, fn: Callable, args: Tuple) -> None:
    dev = torch.device(device)
    # the ranks share the host's cores: each takes its share of intra-op
    # threads and, beside a card, cores of its own, so that no rank's
    # threads queue behind another's and jitter every collective
    share = share_host_threads(world)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        cores = sorted(os.sched_getaffinity(0))
        first = (rank * share) % len(cores)
        os.sched_setaffinity(0, cores[first:first + share])
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(NodeGroup(rank, world, dev, backend), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Tuple = (), *,
          device: str = "cuda", timeout_s: float = 120.0) -> List[int]:
    """Run ``fn(group, *args)`` on ``world`` fresh processes, rank r on
    ``device`` (``cuda``, the default, gives rank r card ``r %
    device_count`` and raises without a card; ``cpu`` runs gloo), in one
    ``torch.distributed`` group (``backend_for``) over a ``FileStore`` in a
    temporary directory (no port, so concurrent callers never collide).
    ``fn`` must be importable by name (a module-level function); ranks
    report through files the caller names in ``args``. On a CUDA device
    the kernels are built here first, once, not by every rank. Returns
    every rank's exit code, all 0; raises when a rank fails, or outlives
    ``timeout_s`` (then it is killed; the group's collectives time out as
    well)."""
    device = resolve_device(device)
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    backend = backend_for(device, world)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(tmp, "store"), backend,
                               str(device), timeout_s, fn, tuple(args)))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + 30.0
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"{getattr(fn, '__name__', fn)} on {world} ranks: "
                           f"exit codes {codes} (nonzero: failed or killed "
                           "at the time limit)")
    return codes
