"""K4 topk_threshold and K5 topk_mask: ``csrc/topk.cu`` and their plain
PyTorch versions.

K4 replaces ``repro/kernels/topk.py:topk_partials_2d`` and the select after
it: per row of a ``[R, D]`` tensor, the exact k-th largest ``|x|`` in the
input dtype (ties inclusive), found by a radix select on the bits of
``|x|``. K5 replaces ``topk_mask_2d``: ``where(|x| >= t[row], x, 0)`` in
the input dtype. Callers go through ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_THRESHOLD_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p)
_MASK_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_void_p)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def threshold_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th largest magnitude, ``[R]`` in x's dtype."""
    return torch.topk(x.abs(), k, dim=1).values[:, k - 1].contiguous()


def mask_plain(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() >= thresh[:, None], x, torch.zeros_like(x))


def launch_threshold(x: torch.Tensor, k: int, out: torch.Tensor) -> None:
    symbol = f"topk_threshold_{_SUFFIX[x.dtype]}"
    fn = build.kernel("topk", symbol, _THRESHOLD_ARGS)
    rows, cols = x.shape
    err = fn(x.data_ptr(), out.data_ptr(), rows, cols, k,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("topk", symbol, err)


def launch_mask(x: torch.Tensor, thresh: torch.Tensor,
                out: torch.Tensor) -> None:
    symbol = f"topk_mask_{_SUFFIX[x.dtype]}"
    fn = build.kernel("topk", symbol, _MASK_ARGS)
    rows, cols = x.shape
    err = fn(x.data_ptr(), thresh.data_ptr(), out.data_ptr(), rows, cols,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("topk", symbol, err)
