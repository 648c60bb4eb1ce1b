"""K3 choco_topk: ``csrc/choco_fused.cu`` and its plain PyTorch version.

Replaces ``repro/kernels/choco_fused.py:choco_topk_2d``. Over stacked
``[N, D]`` leaves, with the gap ``d`` (materialised in the leaf dtype) and
its per-row TopK threshold ``t`` from K4::

    x_new = (x + gamma (my - y)) in f32, cast to the leaf dtype
    y_new = y + where(|d| >= t[row], d, 0) in the leaf dtype

Callers go through ``repro_torch.kernels.ops.choco_topk``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_float, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def move(x: torch.Tensor, y: torch.Tensor, my: torch.Tensor,
         gamma: float) -> torch.Tensor:
    """The consensus move x + gamma (my - y), in f32."""
    return x.float() + gamma * (my.float() - y.float())


def gap(x: torch.Tensor, y: torch.Tensor, my: torch.Tensor,
        gamma: float) -> torch.Tensor:
    """The compressed gap (x + gamma (my - y)) - y, computed in f32 and
    materialised in the leaf dtype: the tensor K4 thresholds and K3 masks
    (the reference's ``ops._fused_diff``)."""
    return (move(x, y, my, gamma) - y.float()).to(x.dtype)


def plain(x, y, my, d, thresh, gamma: float):
    """The kernel's arithmetic in PyTorch; returns (x_new, y_new)."""
    x_new = move(x, y, my, gamma).to(x.dtype)
    q = torch.where(d.abs() >= thresh[:, None], d, torch.zeros_like(d))
    return x_new, y + q


def launch(x, y, my, d, thresh, gamma: float, x_out, y_out) -> None:
    symbol = f"choco_topk_{_SUFFIX[x.dtype]}"
    fn = build.kernel("choco_fused", symbol, _ARGS)
    rows, cols = x.shape
    err = fn(x.data_ptr(), y.data_ptr(), my.data_ptr(), d.data_ptr(),
             thresh.data_ptr(), gamma, x_out.data_ptr(), y_out.data_ptr(),
             rows, cols, torch.cuda.current_stream(x.device).cuda_stream)
    build.check("choco_fused", symbol, err)
