"""Minimal optax-style optimizers over stacked ``[N, ...]`` parameters.

``Optimizer = (init, update)`` with ``update(grads, state, params) ->
(updates, state')`` and ``params' = apply_updates(params, updates)``, as in
``repro.optim.optimizers``. The reference runs ``update`` under ``vmap``
with a scalar step per node; the port writes the node axis out:

  * the state's ``step`` is ``[N]`` int32, one count per node;
  * a learning rate may be a schedule (``repro_torch.optim.schedules``),
    called on ``step`` and giving ``[N]`` f32, broadcast over each leaf;
  * slots (momentum's velocity, AdamW's moments) are f32, one per node.

A constant learning rate stays a Python float, so ``sgd(lr)`` computes
``-lr * g`` exactly as before schedules existed. ``clip_by_global_norm``
keeps the reference's signature, one node's tree and one global norm;
``torch.func.vmap`` maps it over a stacked tree.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["Optimizer", "sgd", "momentum_sgd", "adamw", "apply_updates",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], Tuple[Params, dict]]


def apply_updates(params: Params, updates: Params) -> Params:
    """``params + updates`` per leaf, in the parameter's dtype."""
    return {name: (p + updates[name]).to(p.dtype)
            for name, p in params.items()}


def _steps(params: Params) -> torch.Tensor:
    leaf = next(iter(params.values()))
    return torch.zeros(leaf.shape[0], dtype=torch.int32, device=leaf.device)


def _lr(lr: Union[float, Schedule], step: torch.Tensor, like: torch.Tensor):
    """A constant learning rate as the float itself; a schedule's ``[N]``
    value shaped to broadcast over ``like`` ``[N, ...]``."""
    if not callable(lr):
        return lr
    eta = lr(step)
    return eta.reshape(eta.shape + (1,) * (like.dim() - 1))


def _f32_zeros(params: Params) -> Params:
    return {name: torch.zeros_like(p, dtype=torch.float32)
            for name, p in params.items()}


def sgd(lr: Union[float, Schedule]) -> Optimizer:
    """``update = -lr * g`` per leaf; the state counts steps per node."""

    def init(params: Params) -> dict:
        return {"step": _steps(params)}

    def update(grads: Params, state: dict, params: Params):
        del params
        step = state["step"]
        updates = {name: -_lr(lr, step, g) * g for name, g in grads.items()}
        return updates, {"step": step + 1}

    return Optimizer(init, update)


def momentum_sgd(lr: Union[float, Schedule], beta: float = 0.9,
                 nesterov: bool = False) -> Optimizer:
    """Heavy-ball (or Nesterov) momentum with an f32 velocity per node."""

    def init(params: Params) -> dict:
        return {"step": _steps(params), "velocity": _f32_zeros(params)}

    def update(grads: Params, state: dict, params: Params):
        del params
        step = state["step"]
        v = {name: beta * state["velocity"][name] + g.float()
             for name, g in grads.items()}
        eff = ({name: beta * v[name] + g.float() for name, g in grads.items()}
               if nesterov else v)
        updates = {name: -_lr(lr, step, e) * e for name, e in eff.items()}
        return updates, {"step": step + 1, "velocity": v}

    return Optimizer(init, update)


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay; f32 moments per node, bias
    corrections from each node's own step."""

    def init(params: Params) -> dict:
        return {"step": _steps(params), "mu": _f32_zeros(params),
                "nu": _f32_zeros(params)}

    def update(grads: Params, state: dict, params: Params):
        step = state["step"] + 1
        mu = {name: b1 * state["mu"][name] + (1 - b1) * g.float()
              for name, g in grads.items()}
        nu = {name: b2 * state["nu"][name] + (1 - b2) * torch.square(g.float())
              for name, g in grads.items()}
        t = step.float()
        mu_hat_scale = 1.0 / (1.0 - b1 ** t)
        nu_hat_scale = 1.0 / (1.0 - b2 ** t)

        def upd(m, v, p):
            shape = (-1,) + (1,) * (m.dim() - 1)
            adam = (m * mu_hat_scale.reshape(shape)) / (
                torch.sqrt(v * nu_hat_scale.reshape(shape)) + eps)
            return -_lr(lr, state["step"], m) * (
                adam + weight_decay * p.float())

        updates = {name: upd(mu[name], nu[name], p)
                   for name, p in params.items()}
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """Scale one node's gradient tree to global norm at most ``max_norm``;
    the squares are summed leaf by leaf in the reference's leaf order
    (``core.tree.leaf_order``)."""
    from repro_torch.core.tree import leaf_order

    gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[name].float()))
                           for name in leaf_order(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return {name: g * scale for name, g in grads.items()}
