"""K1 gossip_mix: ``csrc/gossip_mix.cu`` and its plain PyTorch versions.

Replaces ``repro/kernels/gossip_mix.py:gossip_mix_2d``. One gossip step
over every stacked ``[N, D_i]`` leaf of a tree, with one neighbour index
table ``[N, deg]`` int32 and per-node weights ``[N, deg + 1]`` f32 (self
weight first) for all leaves::

    out[i] = w[i, 0] x[i] + sum_k w[i, k + 1] x[nbr[i, k]]

accumulated in f32 in that order and cast to the leaf dtype. One launch
mixes up to ``MAX_LEAVES`` leaves: each block copies one ``[N, tile]``
column slab of one leaf into shared memory and writes its N outputs from
there. ``mix_plans`` cuts the leaves into those tiles; ``tile_span`` is
the kernel's own arithmetic for which columns a block owns. Callers go
through ``repro_torch.kernels.ops.gossip_mix_many``.

The received-buffer form (the reference's own, the sharded engine's step)
mixes one node's leaves ``x [D_i]`` with the ``deg`` buffers ``recv
[deg, D_i]`` the node received, with weights ``w [deg + 1]`` on the
device::

    out = w[0] x + sum_j w[j + 1] recv[j]

in the same f32 order (``plain_received``). One launch streams up to
``MAX_LEAVES`` leaves, a chunk of columns a block: at most ``RECV_CHUNK``,
halved while the call makes fewer than ``build.BLOCKS_PER_SM`` blocks an
SM, down to one 16-byte vector a thread (``received_plans``; ``tile_span``
gives a block's columns). Callers go through
``repro_torch.kernels.ops.gossip_mix_received_many``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

MAX_LEAVES = 32              # leaves per launch (csrc kMaxLeaves)
TILE_MAX = 256               # columns per block at most
SLAB_BYTES = 48 * 1024       # shared memory for one block's [N, tile] slab
MAX_ROWS = SLAB_BYTES // 16  # N at which the slab holds one 16-byte column
RECV_CHUNK = 8192            # columns a block of the received form at most
RECV_THREADS = 256           # threads a block of the received form (csrc)

_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                  ctypes.c_void_p)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


class _CLeaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("cols", ctypes.c_int64), ("tile_begin", ctypes.c_int32),
                ("vec", ctypes.c_int32)]


class _CPlan(ctypes.Structure):
    _fields_ = [("leaf", _CLeaf * MAX_LEAVES), ("num_leaves", ctypes.c_int32),
                ("tile", ctypes.c_int32)]


_RECV_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
              ctypes.c_void_p)


class _CRecvLeaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("recv", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("cols", ctypes.c_int64),
                ("recv_stride", ctypes.c_int64),
                ("block_begin", ctypes.c_int32), ("vec", ctypes.c_int32)]


class _CRecvPlan(ctypes.Structure):
    _fields_ = [("leaf", _CRecvLeaf * MAX_LEAVES),
                ("num_leaves", ctypes.c_int32), ("chunk", ctypes.c_int32)]


@dataclasses.dataclass(frozen=True)
class MixPlan:
    """One launch. Leaf slot ``j`` is the caller's leaf ``index[j]``, with
    ``cols[j]`` columns, owning blocks ``tile_begin[j]`` onwards; every
    block mixes ``tile`` columns (fewer at a leaf's end)."""
    index: Tuple[int, ...]
    cols: Tuple[int, ...]
    tile_begin: Tuple[int, ...]
    tile: int
    blocks: int


def plain(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: separate mul and add, same order."""
    acc = w[:, :1] * x.float()
    for k in range(nbr.shape[1]):
        acc = acc + w[:, k + 1:k + 2] * x[nbr[:, k].long()].float()
    return acc.to(x.dtype)


def plain_received(x: torch.Tensor, recv: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """The received form's arithmetic in PyTorch: ``w[0] x`` then ``+
    w[j + 1] recv[j]`` for each received row, separate mul and add in f32,
    cast to x's dtype; x ``[D]`` or ``[1, D]``, recv ``[deg, D]``."""
    acc = w[0] * x.float()
    for j in range(recv.shape[0]):
        acc = acc + w[j + 1] * recv[j].float()
    return acc.to(x.dtype)


def tile_width(rows: int, itemsize: int) -> int:
    """Columns per block: the widest multiple of one 16-byte vector whose
    ``[rows, tile]`` slab fits in ``SLAB_BYTES``, at most ``TILE_MAX``."""
    vec = 16 // itemsize
    tile = min(TILE_MAX, SLAB_BYTES // (rows * itemsize)) // vec * vec
    if tile < vec:
        raise ValueError(f"gossip_mix: {rows} nodes exceed the {MAX_ROWS} "
                         f"whose slab fits in {SLAB_BYTES // 1024} KB of "
                         "shared memory")
    return tile


def mix_plans(cols: Sequence[int], rows: int, itemsize: int) -> List[MixPlan]:
    """The launches for leaves of ``cols[i]`` columns: at most
    ``MAX_LEAVES`` leaves each, every leaf cut into column tiles."""
    tile = tile_width(rows, itemsize)
    plans = []
    for first in range(0, len(cols), MAX_LEAVES):
        index = tuple(range(first, min(first + MAX_LEAVES, len(cols))))
        begin, blocks = [], 0
        for i in index:
            begin.append(blocks)
            blocks += -(-cols[i] // tile)
        plans.append(MixPlan(index, tuple(cols[i] for i in index),
                             tuple(begin), tile, blocks))
    return plans


def tile_span(plan: MixPlan, block: int) -> Tuple[int, int, int]:
    """(caller's leaf index, first column, end column) of ``block``, as the
    kernel computes them."""
    li = 0
    while li + 1 < len(plan.index) and plan.tile_begin[li + 1] <= block:
        li += 1
    col0 = (block - plan.tile_begin[li]) * plan.tile
    return plan.index[li], col0, min(col0 + plan.tile, plan.cols[li])


@functools.lru_cache(maxsize=None)
def _checked_layout() -> None:
    out = (ctypes.c_int64 * 2)()
    fn = build.kernel("gossip_mix", "gossip_mix_layout",
                      (ctypes.c_void_p,))
    build.check("gossip_mix", "gossip_mix_layout", fn(out))
    if (out[0], out[1]) != (ctypes.sizeof(_CPlan), MAX_LEAVES):
        raise RuntimeError(f"gossip_mix: the kernel's plan is {out[0]} bytes "
                           f"for {out[1]} leaves, the wrapper's "
                           f"{ctypes.sizeof(_CPlan)} for {MAX_LEAVES}")


def launch_many(xs: Sequence[torch.Tensor], nbr: torch.Tensor, w: torch.Tensor,
                outs: Sequence[torch.Tensor]) -> int:
    """Mix ``xs`` into ``outs``; returns the number of kernel launches."""
    _checked_layout()
    dtype = xs[0].dtype
    symbol = f"gossip_mix_{_SUFFIX[dtype]}"
    fn = build.kernel("gossip_mix", symbol, _ARGS)
    rows, deg = nbr.shape
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    launches = 0
    cols = [x.shape[1] for x in xs]
    for plan in mix_plans(cols, rows, xs[0].element_size()):
        c = _CPlan(num_leaves=len(plan.index), tile=plan.tile)
        for slot, i in enumerate(plan.index):
            vec = build.rows_aligned(xs[i]) and build.rows_aligned(outs[i])
            c.leaf[slot] = _CLeaf(xs[i].data_ptr(), outs[i].data_ptr(),
                                  plan.cols[slot], plan.tile_begin[slot],
                                  int(vec))
        err = fn(ctypes.addressof(c), nbr.data_ptr(), w.data_ptr(), rows, deg,
                 plan.blocks, stream)
        build.check("gossip_mix", symbol, err)
        launches += 1
    return launches


def received_plans(cols: Sequence[int], itemsize: int,
                   sms: int) -> List[MixPlan]:
    """The received form's launches for leaves of ``cols[i]`` columns of
    ``itemsize`` bytes on a card of ``sms`` SMs: at most ``MAX_LEAVES``
    leaves each, every leaf cut into chunks of ``tile`` columns, one a
    block, the chunk from ``build.fill_chunk`` between one 16-byte vector
    a thread and ``RECV_CHUNK``."""
    plans = []
    for first in range(0, len(cols), MAX_LEAVES):
        index = tuple(range(first, min(first + MAX_LEAVES, len(cols))))
        chunk = build.fill_chunk([(1, cols[i]) for i in index], RECV_CHUNK,
                                 RECV_THREADS * 16 // itemsize, sms)
        begin, blocks = [], 0
        for i in index:
            begin.append(blocks)
            blocks += -(-cols[i] // chunk)
        plans.append(MixPlan(index, tuple(cols[i] for i in index),
                             tuple(begin), chunk, blocks))
    return plans


@functools.lru_cache(maxsize=None)
def _checked_received_layout() -> None:
    out = (ctypes.c_int64 * 3)()
    fn = build.kernel("gossip_mix", "gossip_mix_received_layout",
                      (ctypes.c_void_p,))
    build.check("gossip_mix", "gossip_mix_received_layout", fn(out))
    want = (ctypes.sizeof(_CRecvPlan), MAX_LEAVES, RECV_THREADS)
    if tuple(out) != want:
        raise RuntimeError(f"gossip_mix_received: the kernel's (plan bytes, "
                           f"leaves, threads) are {tuple(out)}, the "
                           f"wrapper's {want}")


def _received_aligned(x: torch.Tensor, recv: torch.Tensor,
                      out: torch.Tensor) -> bool:
    """True when x, out and every row of recv start 16-byte aligned and
    the rows are whole 16-byte vectors."""
    size = x.element_size()
    return (x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
            and recv.data_ptr() % 16 == 0 and x.numel() * size % 16 == 0
            and recv.stride(0) * size % 16 == 0)


def launch_received_many(xs: Sequence[torch.Tensor],
                         recvs: Sequence[torch.Tensor], w: torch.Tensor,
                         outs: Sequence[torch.Tensor]) -> int:
    """Mix each ``xs[i]`` with its received rows ``recvs[i]`` into
    ``outs[i]``; returns the number of kernel launches."""
    _checked_received_layout()
    dtype = xs[0].dtype
    symbol = f"gossip_mix_received_{_SUFFIX[dtype]}"
    fn = build.kernel("gossip_mix", symbol, _RECV_ARGS)
    deg = recvs[0].shape[0]
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    launches = 0
    sms = build.sm_count(xs[0].device.index)
    for plan in received_plans([x.numel() for x in xs], xs[0].element_size(),
                               sms):
        c = _CRecvPlan(num_leaves=len(plan.index), chunk=plan.tile)
        for slot, i in enumerate(plan.index):
            vec = _received_aligned(xs[i], recvs[i], outs[i])
            c.leaf[slot] = _CRecvLeaf(xs[i].data_ptr(), recvs[i].data_ptr(),
                                      outs[i].data_ptr(), plan.cols[slot],
                                      recvs[i].stride(0),
                                      plan.tile_begin[slot], int(vec))
        err = fn(ctypes.addressof(c), w.data_ptr(), deg, plan.blocks, stream)
        build.check("gossip_mix", symbol, err)
        launches += 1
    return launches
