"""Minimal optax-style optimizers over stacked ``[N, ...]`` parameters.

``Optimizer = (init, update)`` with ``update(grads, state, params) ->
(updates, state')`` and ``params' = params + updates``, as in
``repro.optim.optimizers``. The node axis is a batch dimension written
out: every node carries its own slots. This slice ports ``sgd`` (the
paper trains with plain SGD, Sec. VI-A) with a constant learning rate.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]

__all__ = ["Optimizer", "sgd"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Params]
    update: Callable[[Params, Params, Params], Tuple[Params, Params]]


def sgd(lr: float) -> Optimizer:
    """``update = -lr * g`` per leaf; the state counts steps per node."""

    def init(params: Params) -> Params:
        leaf = next(iter(params.values()))
        return {"step": torch.zeros(leaf.shape[0], dtype=torch.int32,
                                    device=leaf.device)}

    def update(grads: Params, state: Params, params: Params):
        del params
        updates = {name: -lr * g for name, g in grads.items()}
        return updates, {"step": state["step"] + 1}

    return Optimizer(init, update)
