"""The paper's CNNs (Appendix C, Table II) as plain functions on a
parameter dict.

MNIST CNN : conv[1,16,3x3](same) -> ReLU -> maxpool 2x2
            conv[16,32,3x3](same) -> ReLU -> maxpool 2x2
            dense[32*7*7, 10]
CIFAR CNN : conv[3,64,5x5](valid) -> ReLU -> maxpool 3x3/2
            conv[64,64,5x5](valid) -> ReLU -> maxpool 3x3/2
            dense[64*4*4,384] -> ReLU -> dense[384,192] -> ReLU -> dense[192,10]

Parameters keep the reference layout (``repro.models.cnn``): HWIO conv
kernels and ``[fin, fout]`` dense weights, so every gossip and compression
leaf is element for element the reference's. Inputs are NHWC. ``forward``
permutes to NCHW / OIHW for the convolutions and back to NHWC before the
flatten, so ``d1`` sees the reference's feature order.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]

_SHAPES = {
    "mnist": {"c1": (3, 3, 1, 16), "b1": (16,), "c2": (3, 3, 16, 32),
              "b2": (32,), "d1": (32 * 7 * 7, 10), "db1": (10,)},
    "cifar": {"c1": (5, 5, 3, 64), "b1": (64,), "c2": (5, 5, 64, 64),
              "b2": (64,), "d1": (64 * 4 * 4, 384), "db1": (384,),
              "d2": (384, 192), "db2": (192,), "d3": (192, 10),
              "db3": (10,)},
}


def init_cnn(generator: torch.Generator, flavor: str = "mnist",
             device="cuda") -> Params:
    """He-style normal weights (std 1/sqrt(fan_in)) and zero biases, drawn
    on the CPU from ``generator`` so a seed gives the same weights on
    every device."""
    dev = resolve_device(device)
    if flavor not in _SHAPES:
        raise ValueError(flavor)
    params = {}
    for name, shape in _SHAPES[flavor].items():
        if len(shape) == 1:
            params[name] = torch.zeros(shape)
        else:
            fan_in = math.prod(shape[:-1])
            params[name] = torch.randn(shape, generator=generator) / math.sqrt(
                fan_in)
    return {name: p.to(dev) for name, p in params.items()}


def _conv(h, w, b, padding):
    # h NCHW, w HWIO -> OIHW
    return F.conv2d(h, w.permute(3, 2, 0, 1), b, padding=padding)


def cnn_logits(params: Params, x: torch.Tensor,
               flavor: str = "mnist") -> torch.Tensor:
    h = x.permute(0, 3, 1, 2)
    if flavor == "mnist":
        h = F.max_pool2d(F.relu(_conv(h, params["c1"], params["b1"], 1)), 2, 2)
        h = F.max_pool2d(F.relu(_conv(h, params["c2"], params["b2"], 1)), 2, 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return h @ params["d1"] + params["db1"]
    h = F.max_pool2d(F.relu(_conv(h, params["c1"], params["b1"], 0)), 3, 2)
    h = F.max_pool2d(F.relu(_conv(h, params["c2"], params["b2"], 0)), 3, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["d1"] + params["db1"])
    h = F.relu(h @ params["d2"] + params["db2"])
    return h @ params["d3"] + params["db3"]


def cnn_loss(params: Params, batch: Tuple[torch.Tensor, torch.Tensor],
             flavor: str = "mnist") -> torch.Tensor:
    """Mean cross-entropy: logsumexp(logits) - logits[label]."""
    x, y = batch
    logits = cnn_logits(params, x, flavor).float()
    gold = logits.gather(1, y[:, None].long())[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def cnn_accuracy(params: Params, x: torch.Tensor, y: torch.Tensor,
                 flavor: str = "mnist") -> torch.Tensor:
    logits = cnn_logits(params, x, flavor)
    return (logits.argmax(-1) == y).float().mean()
