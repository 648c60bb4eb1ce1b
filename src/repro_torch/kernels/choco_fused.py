"""K2 choco_qsgd and K3 choco_topk: ``csrc/choco_fused.cu`` and their
plain PyTorch versions, the fused CHOCO-G steps.

K3 replaces ``repro/kernels/choco_fused.py:choco_topk_2d``. Over stacked
``[N, D]`` leaves, with the gap ``d`` (materialised in the leaf dtype) and
its per-row TopK threshold ``t`` from K4::

    x_new = (x + gamma (my - y)) in f32, cast to the leaf dtype
    y_new = y + where(|d| >= t[row], d, 0) in the leaf dtype

K2 replaces ``choco_qsgd_2d``: the same ``x_new``, and ``y_new = y + q``
with ``q`` the QSGD of the gap (``qsgd.plain``), given each row's f32 norm
of the gap and f32 uniform noise. K2 recomputes the gap itself.

Callers go through ``repro_torch.kernels.ops.choco_topk`` / ``choco_qsgd``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, qsgd

_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_float, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p)
_QSGD_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_float,) * 3 + (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def move(x: torch.Tensor, y: torch.Tensor, my: torch.Tensor,
         gamma: float) -> torch.Tensor:
    """The consensus move x + gamma (my - y), in f32."""
    return x.float() + gamma * (my.float() - y.float())


# elements of a leaf above which ``gap`` works a column chunk at a time
GAP_CHUNK = 1 << 26


def gap(x: torch.Tensor, y: torch.Tensor, my: torch.Tensor,
        gamma: float) -> torch.Tensor:
    """The compressed gap (x + gamma (my - y)) - y, computed in f32 and
    materialised in the leaf dtype: the tensor K4 thresholds and K3 masks,
    and whose norm K2 takes (the reference's ``ops._fused_diff``). A leaf
    ``[rows, cols]`` of more than ``GAP_CHUNK`` elements (an LM's
    embedding: 1.24 G for four nodes) is done in column chunks, so its f32
    temporaries stay near ``GAP_CHUNK`` elements; every element is the
    same arithmetic either way."""
    if x.numel() <= GAP_CHUNK:
        return (move(x, y, my, gamma) - y.float()).to(x.dtype)
    out = torch.empty_like(x)
    width = max(1, GAP_CHUNK // x.shape[0])
    for c0 in range(0, x.shape[1], width):
        cols = slice(c0, c0 + width)
        out[:, cols] = gap(x[:, cols], y[:, cols], my[:, cols], gamma)
    return out


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


def qsgd_plain(x, y, my, noise, norm, gamma: float, levels: float, sc: float):
    """K2's arithmetic in PyTorch; returns (x_new, y_new)."""
    m = move(x, y, my, gamma)
    d = (m - y.float()).to(x.dtype)
    return m.to(x.dtype), y + qsgd.plain(d, noise, norm, levels, sc)


def launch_qsgd(x, y, my, noise, norm, gamma: float, levels: float,
                sc: float, x_out, y_out) -> None:
    symbol = f"choco_qsgd_{_SUFFIX[x.dtype]}"
    fn = build.kernel("choco_fused", symbol, _QSGD_ARGS)
    rows, cols = x.shape
    err = fn(x.data_ptr(), y.data_ptr(), my.data_ptr(), noise.data_ptr(),
             norm.data_ptr(), gamma, levels, sc, x_out.data_ptr(),
             y_out.data_ptr(), rows, cols,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("choco_fused", symbol, err)
