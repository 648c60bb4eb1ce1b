"""K1 gossip_mix: ``csrc/gossip_mix.cu`` and its plain PyTorch version.

Replaces ``repro/kernels/gossip_mix.py:gossip_mix_2d``. One gossip step
over a stacked ``[N, D]`` leaf with a neighbour index table ``[N, deg]``
int32 and per-node weights ``[N, deg + 1]`` f32 (self weight first)::

    out[i] = w[i, 0] x[i] + sum_k w[i, k + 1] x[nbr[i, k]]

accumulated in f32 in that order and cast to the leaf dtype. Callers go
through ``repro_torch.kernels.ops.gossip_mix``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int, ctypes.c_void_p)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def plain(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: separate mul and add, same order."""
    acc = w[:, :1] * x.float()
    for k in range(nbr.shape[1]):
        acc = acc + w[:, k + 1:k + 2] * x[nbr[:, k].long()].float()
    return acc.to(x.dtype)


def launch(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
           out: torch.Tensor) -> None:
    symbol = f"gossip_mix_{_SUFFIX[x.dtype]}"
    fn = build.kernel("gossip_mix", symbol, _ARGS)
    rows, cols = x.shape
    err = fn(x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
             rows, cols, nbr.shape[1],
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("gossip_mix", symbol, err)
