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
"""
from __future__ import annotations

import collections
import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device

__all__ = ["NodeGroup", "backend_for", "local_rows", "pack_layout", "spawn"]

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


class NodeGroup:
    """This process's place in the node group: ``rank`` (the node it
    holds), ``world`` (the number of nodes), ``device`` (where its leaves
    and kernels live) and ``backend`` (``gloo`` or ``nccl``, as the caller
    initialised ``torch.distributed``)."""

    def __init__(self, rank: int, world: int, device, backend: str):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.backend = backend
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend moves device tensors; give "
                             "the group a CUDA device")
        # host staging is the gloo backend's on a CUDA device
        self.staged = backend == "gloo" and self.device.type == "cuda"
        # seconds the exchanges took (host clock, waits for the device
        # included) and the bytes this node sent in them (the packed
        # buffer, once a shift), for the callers' reports and the roofline's
        # collective term (``launch.roofline``)
        self.exchange_s = 0.0
        self.exchange_bytes = 0
        # how many sends ``shift_exchange`` made to each (src, dst): a host
        # counter, at most one key a shift, for the collective audits
        # (``repro_torch.analysis.audits``)
        self.sends: collections.Counter = collections.Counter()

    @classmethod
    def current(cls, device) -> "NodeGroup":
        """The group of the initialised default process group."""
        if not dist.is_initialized():
            raise ValueError("torch.distributed is not initialised: the "
                             "sparse engine runs one rank per node")
        return cls(dist.get_rank(), dist.get_world_size(), device,
                   dist.get_backend())

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
        """A staged tensor back on the group's device."""
        return t.to(self.device, non_blocking=True) if self.staged else t

    def shift_exchange(self, leaves: Sequence[torch.Tensor],
                       shifts: Sequence[int]) -> List[torch.Tensor]:
        """Send this node's flat ``leaves`` to rank (r + s) mod N and
        receive rank (r - s) mod N's, for each shift s; returns, for each
        leaf, its ``[len(shifts), D]`` received copies (row j from shift
        j's sender), in the leaf's dtype on the group's device. The tree
        travels as one packed byte buffer a shift, each leaf 16-byte
        aligned in it. Each send is counted in ``sends`` under its
        (src, dst) and its bytes added to ``exchange_bytes``."""
        t0 = time.perf_counter()
        offsets, total = pack_layout(leaves)
        send = torch.empty(total, dtype=torch.uint8, device=self.device)
        for x, at in zip(leaves, offsets):
            nb = x.numel() * x.element_size()
            send[at:at + nb].copy_(x.reshape(-1).view(torch.uint8))
        send = self._staging(send)
        recv = torch.empty((len(shifts), total), dtype=torch.uint8,
                           device=send.device, pin_memory=self.staged)
        ops = []
        for j, s in enumerate(shifts):
            dst = (self.rank + s) % self.world
            ops.append(dist.P2POp(dist.isend, send, dst, tag=j))
            self.sends[(self.rank, dst)] += 1
            ops.append(dist.P2POp(dist.irecv, recv[j], (self.rank - s)
                                  % self.world, tag=j))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        recv = self._home(recv)
        self.exchange_s += time.perf_counter() - t0
        self.exchange_bytes += total * len(shifts)
        out = []
        for x, at in zip(leaves, offsets):
            nb = x.numel() * x.element_size()
            out.append(recv[:, at:at + nb].view(x.dtype))
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, a new tensor on ``t``'s
        device."""
        buf = self._staging(t.contiguous())
        if buf is t or buf.data_ptr() == t.data_ptr():
            buf = buf.clone()
        dist.all_reduce(buf)
        return self._home(buf)

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
    share = max(1, (os.cpu_count() or 1) // world)
    torch.set_num_threads(share)
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
