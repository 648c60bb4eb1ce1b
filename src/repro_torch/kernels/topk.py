"""K4 topk_threshold and K5 topk_mask: ``csrc/topk.cu`` and their plain
PyTorch versions.

K4 replaces ``repro/kernels/topk.py:topk_partials_2d`` and the select after
it: per row of each ``[R_i, D_i]`` leaf of a list, the exact k_i-th largest
``|x|`` in the input dtype (ties inclusive), found by a radix select on the
bits of ``|x|`` below the sign, one digit of ``DIGITS`` bits a pass, top
digit first. One call covers up to ``MAX_LEAVES`` leaves: every row is cut
into chunks of ``CHUNK`` keys, one block each. A row of one chunk is
selected whole in the first launch; the rows of several chunks take one
launch per digit (``select_plans``, with ``chunk_span`` the kernel's own
arithmetic for which keys a block owns). K5 replaces ``topk_mask_2d``:
``where(|x| >= t[row], x, 0)`` in the input dtype, over up to
``MAX_LEAVES`` leaves a launch, each row cut into chunks of at most
``MASK_CHUNK`` elements, one block each (``mask_plans``; ``chunk_span``
gives a block's chunk), moved 16 bytes at a time from the chunk's first
16-byte boundary, with a scalar head and tail (all scalar where x and out
are not congruent modulo 16 bytes). Callers go through
``repro_torch.kernels.ops``.

K4's sharded-row form (``launch_threshold_sharded_many``) selects the same
threshold for rows split over the ranks of a gossip-fsdp mesh: every row
a segment of its own (``select_plans(..., segment_all=True)``), one count
launch and one pick launch a digit, the histograms summed over the row's
ranks in between by the caller's ``reduce``. Its plain version gathers
the row's parts and selects on the whole row
(``threshold_sharded_plain``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

CHUNK = 16384          # keys per block
MASK_CHUNK = 8192      # K5: elements a block at most
MASK_THREADS = 256     # K5: threads a block (csrc kMaskThreads)
MAX_LEAVES = 32        # leaves per call (csrc kMaxLeaves)
MAX_PASSES = 4         # csrc kMaxPasses
MAX_DIGIT_BITS = 11    # csrc kMaxBins = 2 ** 11
# digit widths, top digit first, over the bits of |x| below the sign
DIGITS: Dict[torch.dtype, Tuple[int, ...]] = {torch.float32: (11, 10, 10),
                                              torch.bfloat16: (8, 7)}

_SELECT_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int64, ctypes.c_void_p)
_MASK_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p)
_SHARD_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int64, ctypes.c_void_p)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


class _CLeaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("cols", ctypes.c_int64), ("k", ctypes.c_int64),
                ("chunk_begin", ctypes.c_int32),
                ("chunks_per_row", ctypes.c_int32),
                ("seg_begin", ctypes.c_int32), ("vec", ctypes.c_int32)]


class _CPlan(ctypes.Structure):
    _fields_ = [("leaf", _CLeaf * MAX_LEAVES), ("num_leaves", ctypes.c_int32),
                ("chunk", ctypes.c_int32), ("passes", ctypes.c_int32),
                ("num_segs", ctypes.c_int32),
                ("shift", ctypes.c_int32 * MAX_PASSES),
                ("bits", ctypes.c_int32 * MAX_PASSES)]


class _CMaskLeaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("thresh", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("cols", ctypes.c_int64),
                ("chunk_begin", ctypes.c_int32),
                ("chunks_per_row", ctypes.c_int32)]


class _CMaskPlan(ctypes.Structure):
    _fields_ = [("leaf", _CMaskLeaf * MAX_LEAVES),
                ("num_leaves", ctypes.c_int32), ("chunk", ctypes.c_int32)]


@dataclasses.dataclass(frozen=True)
class SelectPlan:
    """One call's launches. Leaf slot ``j`` is the caller's leaf
    ``index[j]`` (``rows[j]`` x ``cols[j]``), owning blocks
    ``chunk_begin[j]`` onwards, ``chunks_per_row[j]`` a row; the slots of
    several chunks a row come first and own scratch segments
    ``seg_begin[j]`` onwards (-1 for the others). The first launch runs
    ``blocks`` blocks, every later one ``multi_blocks``."""
    index: Tuple[int, ...]
    rows: Tuple[int, ...]
    cols: Tuple[int, ...]
    chunk_begin: Tuple[int, ...]
    chunks_per_row: Tuple[int, ...]
    seg_begin: Tuple[int, ...]
    chunk: int
    blocks: int
    multi_blocks: int
    segments: int


def digit_passes(dtype: torch.dtype) -> List[Tuple[int, int]]:
    """(shift, bits) of each pass, top digit first: the digit of a key is
    ``(key >> shift) & (2 ** bits - 1)``."""
    shift = sum(DIGITS[dtype])
    out = []
    for bits in DIGITS[dtype]:
        shift -= bits
        out.append((shift, bits))
    return out


def select_plans(shapes: Sequence[Tuple[int, int]], chunk: int = CHUNK,
                 segment_all: bool = False) -> List[SelectPlan]:
    """The calls for leaves of ``shapes[i] = (rows, cols)``: at most
    ``MAX_LEAVES`` leaves each, every row cut into chunks of ``chunk``.
    ``segment_all``: every row owns a scratch segment, in the leaves'
    order (the sharded-row form, whose rows all take every pass)."""
    if chunk < 16 or chunk % 16:
        raise ValueError(f"topk_threshold: chunk {chunk} is not a positive "
                         "multiple of 16")
    plans = []
    for first in range(0, len(shapes), MAX_LEAVES):
        group = range(first, min(first + MAX_LEAVES, len(shapes)))
        order = (list(group) if segment_all
                 else [i for i in group if shapes[i][1] > chunk]
                 + [i for i in group if shapes[i][1] <= chunk])
        begin, per_row, seg_begin = [], [], []
        blocks = segments = multi_blocks = 0
        for i in order:
            rows, cols = shapes[i]
            n = -(-cols // chunk)
            begin.append(blocks)
            per_row.append(n)
            blocks += rows * n
            if n > 1 or segment_all:
                seg_begin.append(segments)
                segments += rows
                multi_blocks = blocks
            else:
                seg_begin.append(-1)
        plans.append(SelectPlan(
            tuple(order), tuple(shapes[i][0] for i in order),
            tuple(shapes[i][1] for i in order), tuple(begin), tuple(per_row),
            tuple(seg_begin), chunk, blocks, multi_blocks, segments))
    return plans


@dataclasses.dataclass(frozen=True)
class MaskPlan:
    """One K5 launch. Leaf slot ``j`` is the caller's leaf ``index[j]``,
    with rows of ``cols[j]`` elements, owning blocks ``chunk_begin[j]``
    onwards, ``chunks_per_row[j]`` a row of ``chunk`` elements; ``blocks``
    in all."""
    index: Tuple[int, ...]
    cols: Tuple[int, ...]
    chunk_begin: Tuple[int, ...]
    chunks_per_row: Tuple[int, ...]
    chunk: int
    blocks: int


def mask_plans(shapes: Sequence[Tuple[int, int]], itemsize: int, sms: int,
               chunk: Optional[int] = None) -> List[MaskPlan]:
    """K5's launches for leaves of ``shapes[i] = (rows, cols)`` of
    ``itemsize`` bytes on a card of ``sms`` SMs: at most ``MAX_LEAVES``
    leaves each, every row cut into chunks from ``build.fill_chunk``
    between one 16-byte vector a thread and ``MASK_CHUNK`` (or of
    ``chunk``, a multiple of one vector, where given)."""
    vec = 16 // itemsize
    if chunk is not None and (chunk < vec or chunk % vec):
        raise ValueError(f"topk_mask: chunk {chunk} is not a positive "
                         f"multiple of {vec}")
    plans = []
    for first in range(0, len(shapes), MAX_LEAVES):
        index = tuple(range(first, min(first + MAX_LEAVES, len(shapes))))
        size = chunk or build.fill_chunk([shapes[i] for i in index],
                                         MASK_CHUNK, MASK_THREADS * vec, sms)
        begin, per_row, blocks = [], [], 0
        for i in index:
            rows, cols = shapes[i]
            begin.append(blocks)
            per_row.append(-(-cols // size))
            blocks += rows * per_row[-1]
        if blocks >= 2 ** 31:
            raise ValueError(f"topk_mask: {blocks} blocks exceed the grid")
        plans.append(MaskPlan(index, tuple(shapes[i][1] for i in index),
                              tuple(begin), tuple(per_row), size, blocks))
    return plans


def chunk_span(plan, block: int) -> Tuple[int, int, int, int]:
    """(caller's leaf index, row, first key, end key) of ``block`` of a
    ``SelectPlan`` or a ``MaskPlan``, as the kernels compute them."""
    li = 0
    while li + 1 < len(plan.index) and plan.chunk_begin[li + 1] <= block:
        li += 1
    local = block - plan.chunk_begin[li]
    row, c = divmod(local, plan.chunks_per_row[li])
    start = c * plan.chunk
    return plan.index[li], row, start, min(start + plan.chunk, plan.cols[li])


def threshold_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th largest magnitude, ``[R]`` in x's dtype."""
    return torch.topk(x.abs(), k, dim=1).values[:, k - 1].contiguous()


def threshold_sharded_plain(x: torch.Tensor, k: int,
                            gather_cols) -> torch.Tensor:
    """K4's sharded-row form, plainly: ``gather_cols`` puts the rows' parts
    together (in any order of elements) and the whole rows select."""
    return threshold_plain(gather_cols(x), k)


def mask_plain(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() >= thresh[:, None], x, torch.zeros_like(x))


@functools.lru_cache(maxsize=None)
def _checked_layout() -> None:
    out = (ctypes.c_int64 * 4)()
    fn = build.kernel("topk", "topk_select_layout", (ctypes.c_void_p,))
    build.check("topk", "topk_select_layout", fn(out))
    want = (ctypes.sizeof(_CPlan), MAX_LEAVES, MAX_PASSES,
            2 ** MAX_DIGIT_BITS)
    if tuple(out) != want:
        raise RuntimeError(f"topk_threshold: the kernel's plan layout "
                           f"{tuple(out)} differs from the wrapper's {want}")


def launch_threshold_many(xs: Sequence[torch.Tensor], ks: Sequence[int],
                          outs: Sequence[torch.Tensor],
                          chunk: int = CHUNK) -> int:
    """Thresholds of ``xs`` into ``outs``; returns the number of kernel
    launches."""
    _checked_layout()
    dtype = xs[0].dtype
    passes = digit_passes(dtype)
    symbol = f"topk_select_{_SUFFIX[dtype]}"
    fn = build.kernel("topk", symbol, _SELECT_ARGS)
    device = xs[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    launches = 0
    for plan in select_plans([tuple(x.shape) for x in xs], chunk):
        c = _plan_struct(plan, xs, ks, outs, passes)
        words = plan.segments * (2 ** MAX_DIGIT_BITS + len(passes) + 2)
        scratch = torch.zeros(max(words, 1), dtype=torch.int32, device=device)
        for p in range(len(passes) if plan.multi_blocks else 1):
            err = fn(ctypes.addressof(c), scratch.data_ptr(), p,
                     plan.blocks if p == 0 else plan.multi_blocks, stream)
            build.check("topk", symbol, err)
            launches += 1
    return launches


def _plan_struct(plan: SelectPlan, xs, ks, outs, passes) -> _CPlan:
    c = _CPlan(num_leaves=len(plan.index), chunk=plan.chunk,
               passes=len(passes), num_segs=plan.segments)
    for p, (shift, bits) in enumerate(passes):
        c.shift[p], c.bits[p] = shift, bits
    for slot, i in enumerate(plan.index):
        c.leaf[slot] = _CLeaf(xs[i].data_ptr(), outs[i].data_ptr(),
                              plan.cols[slot], ks[i], plan.chunk_begin[slot],
                              plan.chunks_per_row[slot], plan.seg_begin[slot],
                              int(build.rows_aligned(xs[i])))
    return c


def launch_threshold_sharded_many(xs: Sequence[torch.Tensor],
                                  ks: Sequence[int],
                                  outs: Sequence[torch.Tensor],
                                  reduce: Callable[[torch.Tensor],
                                                   torch.Tensor],
                                  chunk: int = CHUNK) -> int:
    """Thresholds of the whole rows whose parts ``xs`` holds into ``outs``
    (``ks[i]``: the rank within leaf i's whole row); ``reduce`` sums an
    int32 histogram buffer over the rows' ranks (every rank calls it as
    often, in the same order). Returns the number of kernel launches: one
    count and one pick launch a digit a call of ``MAX_LEAVES`` leaves."""
    _checked_layout()
    dtype = xs[0].dtype
    passes = digit_passes(dtype)
    count = build.kernel("topk", f"topk_shard_count_{_SUFFIX[dtype]}",
                         _SHARD_ARGS)
    pick = build.kernel("topk", f"topk_shard_pick_{_SUFFIX[dtype]}",
                        _SHARD_ARGS)
    device = xs[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    launches = 0
    for plan in select_plans([tuple(x.shape) for x in xs], chunk,
                             segment_all=True):
        c = _plan_struct(plan, xs, ks, outs, passes)
        state = torch.empty(2 * plan.segments, dtype=torch.int32,
                            device=device)
        for p, (_, bits) in enumerate(passes):
            hist = torch.zeros(plan.segments << bits, dtype=torch.int32,
                               device=device)
            build.check("topk", "topk_shard_count", count(
                ctypes.addressof(c), state.data_ptr(), hist.data_ptr(), p,
                plan.blocks, stream))
            hist = reduce(hist)
            build.check("topk", "topk_shard_pick", pick(
                ctypes.addressof(c), hist.data_ptr(), state.data_ptr(), p,
                plan.segments, stream))
            launches += 2
    return launches


@functools.lru_cache(maxsize=None)
def _checked_mask_layout() -> None:
    out = (ctypes.c_int64 * 3)()
    fn = build.kernel("topk", "topk_mask_layout", (ctypes.c_void_p,))
    build.check("topk", "topk_mask_layout", fn(out))
    want = (ctypes.sizeof(_CMaskPlan), MAX_LEAVES, MASK_THREADS)
    if tuple(out) != want:
        raise RuntimeError(f"topk_mask: the kernel's (plan bytes, leaves, "
                           f"threads) are {tuple(out)}, the wrapper's {want}")


def launch_mask_many(xs: Sequence[torch.Tensor],
                     threshs: Sequence[torch.Tensor],
                     outs: Sequence[torch.Tensor],
                     chunk: Optional[int] = None) -> int:
    """Mask ``xs`` by their row thresholds into ``outs``; returns the
    number of kernel launches."""
    _checked_mask_layout()
    symbol = f"topk_mask_{_SUFFIX[xs[0].dtype]}"
    fn = build.kernel("topk", symbol, _MASK_ARGS)
    device = xs[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    plans = mask_plans([tuple(x.shape) for x in xs], xs[0].element_size(),
                       build.sm_count(device.index), chunk)
    for plan in plans:
        c = _CMaskPlan(num_leaves=len(plan.index), chunk=plan.chunk)
        for slot, i in enumerate(plan.index):
            c.leaf[slot] = _CMaskLeaf(xs[i].data_ptr(), threshs[i].data_ptr(),
                                      outs[i].data_ptr(), plan.cols[slot],
                                      plan.chunk_begin[slot],
                                      plan.chunks_per_row[slot])
        build.check("topk", symbol, fn(ctypes.addressof(c), plan.blocks,
                                       stream))
    return len(plans)
