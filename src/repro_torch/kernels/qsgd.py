"""K6 qsgd_quantize: ``csrc/qsgd.cu`` and its plain PyTorch version.

Replaces ``repro/kernels/qsgd.py:qsgd_quantize_2d``. Per row of each
stacked ``[rows, D]`` leaf of a tree, with the row's f32 norm handed in,
f32 uniform noise ``xi`` of the leaf's shape and the leaf's f32 constant
``sc = s * c``::

    q = sign(x) ||x|| floor(s |x| / ||x|| + xi) / sc    (0 if ||x|| = 0)

computed in f32 in that order and cast to the leaf dtype; ``sign(+-0)`` is
``+0``. K2 (``choco_fused.qsgd_plain``) quantizes the CHOCO gap the same
way. One launch quantizes up to ``MAX_LEAVES`` leaves: every row is cut
into chunks of ``CHUNK`` elements, one block each (``quantize_plans``,
with ``chunk_span`` the kernel's own arithmetic for which elements a block
owns). Callers go through ``repro_torch.kernels.ops.qsgd_quantize_many``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

CHUNK = 2048           # elements per block (picked by a sweep on the card)
MAX_LEAVES = 32        # leaves per launch (csrc kMaxLeaves)
MAX_BLOCKS = 2 ** 31 - 1

_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


class _CLeaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("noise", ctypes.c_void_p),
                ("norm", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("cols", ctypes.c_int64), ("sc", ctypes.c_float),
                ("chunk_begin", ctypes.c_int32),
                ("chunks_per_row", ctypes.c_int32), ("vec", ctypes.c_int32)]


class _CPlan(ctypes.Structure):
    _fields_ = [("leaf", _CLeaf * MAX_LEAVES), ("num_leaves", ctypes.c_int32),
                ("chunk", ctypes.c_int32), ("s", ctypes.c_float)]


@dataclasses.dataclass(frozen=True)
class QuantizePlan:
    """One launch. Leaf slot ``j`` is the caller's leaf ``index[j]``
    (``rows[j]`` x ``cols[j]``), owning blocks ``chunk_begin[j]`` onwards,
    ``chunks_per_row[j]`` a row, ``chunk`` elements each (fewer at a row's
    end)."""
    index: Tuple[int, ...]
    rows: Tuple[int, ...]
    cols: Tuple[int, ...]
    chunk_begin: Tuple[int, ...]
    chunks_per_row: Tuple[int, ...]
    chunk: int
    blocks: int


def scale(levels: float, c: float) -> float:
    """``s * c`` rounded once to f32, as the reference's f32 arithmetic
    takes the Python product: the one constant both the kernel and the
    plain version divide by."""
    return float(np.float32(float(levels) * float(c)))


def plain(x: torch.Tensor, noise: torch.Tensor, norm: torch.Tensor,
          levels: float, sc: float) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch. Every operand is a tensor, so
    no division by a scalar is turned into a multiplication."""
    v = x.float()
    n = norm[:, None]
    safe = torch.where(n > 0, n, torch.ones_like(n))
    lvl = torch.floor(float(levels) * v.abs() / safe + noise)
    sign = (v > 0).float() - (v < 0).float()
    q = sign * safe * lvl / torch.full_like(n, sc)
    return torch.where(n > 0, q, torch.zeros_like(q)).to(x.dtype)


def quantize_plans(shapes: Sequence[Tuple[int, int]],
                   chunk: int = CHUNK) -> List[QuantizePlan]:
    """The launches for leaves of ``shapes[i] = (rows, cols)``: at most
    ``MAX_LEAVES`` leaves each, every row cut into chunks of ``chunk``
    elements, a multiple of 8 so that a chunk of a 16-byte aligned row
    starts 16-byte aligned in either dtype."""
    if chunk < 8 or chunk % 8:
        raise ValueError(f"qsgd_quantize: chunk {chunk} is not a positive "
                         "multiple of 8")
    plans = []
    for first in range(0, len(shapes), MAX_LEAVES):
        index = tuple(range(first, min(first + MAX_LEAVES, len(shapes))))
        begin, per_row, blocks = [], [], 0
        for i in index:
            rows, cols = shapes[i]
            begin.append(blocks)
            per_row.append(-(-cols // chunk))
            blocks += rows * per_row[-1]
        if blocks > MAX_BLOCKS:
            raise ValueError(f"qsgd_quantize: {blocks} blocks exceed the "
                             "launch grid")
        plans.append(QuantizePlan(index, tuple(shapes[i][0] for i in index),
                                  tuple(shapes[i][1] for i in index),
                                  tuple(begin), tuple(per_row), chunk, blocks))
    return plans


def chunk_span(plan: QuantizePlan, block: int) -> Tuple[int, int, int, int]:
    """(caller's leaf index, row, first column, end column) of ``block``, as
    the kernel computes them."""
    li = 0
    while li + 1 < len(plan.index) and plan.chunk_begin[li + 1] <= block:
        li += 1
    row, c = divmod(block - plan.chunk_begin[li], plan.chunks_per_row[li])
    start = c * plan.chunk
    return plan.index[li], row, start, min(start + plan.chunk, plan.cols[li])


def pack_plan(plan: QuantizePlan, xs, noises, norms, levels: float,
              scs: Sequence[float], outs) -> _CPlan:
    """The kernel's ``QsgdPlan`` for ``plan``: each slot's pointers, its
    ``sc``, its chunks, and the vector path where every row of x, noise
    and out starts 16-byte aligned."""
    c = _CPlan(num_leaves=len(plan.index), chunk=plan.chunk, s=levels)
    for slot, i in enumerate(plan.index):
        vec = all(build.rows_aligned(t) for t in (xs[i], noises[i], outs[i]))
        c.leaf[slot] = _CLeaf(xs[i].data_ptr(), noises[i].data_ptr(),
                              norms[i].data_ptr(), outs[i].data_ptr(),
                              plan.cols[slot], scs[i], plan.chunk_begin[slot],
                              plan.chunks_per_row[slot], int(vec))
    return c


@functools.lru_cache(maxsize=None)
def checked_layout() -> Tuple[int, int, int]:
    """The kernel's (sizeof(QsgdPlan), leaves, sizeof(QsgdLeaf)), held
    against the wrapper's ctypes structs; raises where they differ."""
    out = (ctypes.c_int64 * 3)()
    fn = build.kernel("qsgd", "qsgd_quantize_layout", (ctypes.c_void_p,))
    build.check("qsgd", "qsgd_quantize_layout", fn(out))
    want = (ctypes.sizeof(_CPlan), MAX_LEAVES, ctypes.sizeof(_CLeaf))
    if tuple(out) != want:
        raise RuntimeError(f"qsgd_quantize: the kernel's plan layout "
                           f"{tuple(out)} differs from the wrapper's {want}")
    return want


def kernel_attributes() -> dict:
    """Registers and local (spill) bytes a thread of each dtype's kernel,
    as the loaded library reports them."""
    out = (ctypes.c_int64 * 4)()
    fn = build.kernel("qsgd", "qsgd_quantize_attributes", (ctypes.c_void_p,))
    build.check("qsgd", "qsgd_quantize_attributes", fn(out))
    return {"f32": {"registers": out[0], "local_bytes": out[1]},
            "bf16": {"registers": out[2], "local_bytes": out[3]}}


def launch_many(xs: Sequence[torch.Tensor], noises: Sequence[torch.Tensor],
                norms: Sequence[torch.Tensor], levels: float,
                scs: Sequence[float], outs: Sequence[torch.Tensor],
                chunk: int = CHUNK) -> int:
    """Quantize ``xs`` into ``outs``; returns the number of kernel
    launches."""
    checked_layout()
    symbol = f"qsgd_quantize_{_SUFFIX[xs[0].dtype]}"
    fn = build.kernel("qsgd", symbol, _ARGS)
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    launches = 0
    for plan in quantize_plans([tuple(x.shape) for x in xs], chunk):
        c = pack_plan(plan, xs, noises, norms, levels, scs, outs)
        build.check("qsgd", symbol,
                    fn(ctypes.addressof(c), plan.blocks, stream))
        launches += 1
    return launches
