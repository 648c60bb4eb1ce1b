"""K6 qsgd_quantize: ``csrc/qsgd.cu`` and its plain PyTorch version.

Replaces ``repro/kernels/qsgd.py:qsgd_quantize_2d``. Per row of a stacked
``[N, D]`` leaf, with the row's f32 norm handed in, f32 uniform noise
``xi`` of the leaf's shape and the f32 constant ``sc = s * c``::

    q = sign(x) ||x|| floor(s |x| / ||x|| + xi) / sc    (0 if ||x|| = 0)

computed in f32 in that order and cast to the leaf dtype; ``sign(+-0)`` is
``+0``. K2 (``choco_fused.qsgd_plain``) quantizes the CHOCO gap the same
way. Callers go through ``repro_torch.kernels.ops.qsgd_quantize``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_float, ctypes.c_float,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def launch(x, noise, norm, levels: float, sc: float, out) -> None:
    symbol = f"qsgd_quantize_{_SUFFIX[x.dtype]}"
    fn = build.kernel("qsgd", symbol, _ARGS)
    rows, cols = x.shape
    err = fn(x.data_ptr(), noise.data_ptr(), norm.data_ptr(), levels, sc,
             out.data_ptr(), rows, cols,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("qsgd", symbol, err)
