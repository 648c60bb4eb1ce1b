"""K7 choco_move: ``csrc/choco_update.cu`` and its plain PyTorch version.

Replaces ``repro/kernels/choco_update.py:choco_move_2d``. Over stacked
``[N, D]`` leaves::

    x_new = (x + gamma (my - y)) in f32, cast to the leaf dtype
    d     = (x_new - y) from the f32 x_new, cast to the leaf dtype

``d`` is ``choco_fused.gap``: the gap that compressors without a fused
kernel compress next. Callers go through ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.choco_fused import move

_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_float, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def plain(x, y, my, gamma: float):
    """The kernel's arithmetic in PyTorch; returns (x_new, d)."""
    m = move(x, y, my, gamma)
    return m.to(x.dtype), (m - y.float()).to(x.dtype)


def launch(x, y, my, gamma: float, x_out, d_out) -> None:
    symbol = f"choco_move_{_SUFFIX[x.dtype]}"
    fn = build.kernel("choco_update", symbol, _ARGS)
    rows, cols = x.shape
    err = fn(x.data_ptr(), y.data_ptr(), my.data_ptr(), gamma,
             x_out.data_ptr(), d_out.data_ptr(), rows, cols,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("choco_update", symbol, err)
