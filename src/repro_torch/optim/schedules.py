"""Learning-rate schedules, including the paper's eta_k = 4 / (mu (a + k))
decay of C-DFL's Proposition 2 (``repro.optim.schedules``).

Each schedule maps an int32 step tensor (the optimizers pass ``[N]``, one
step per node) to an f32 tensor of the same shape.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_decay", "warmup_cosine", "step_decay",
           "cdfl_decay"]


def constant(value: float):
    def sched(step: torch.Tensor) -> torch.Tensor:
        return torch.full(step.shape, value, dtype=torch.float32,
                          device=step.device)

    return sched


def cosine_decay(peak: float, total_steps: int, floor: float = 0.0):
    def sched(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))

    return sched


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    cos = cosine_decay(peak, max(total_steps - warmup_steps, 1), floor)

    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(step - warmup_steps))

    return sched


def step_decay(base: float, drop: float, every: int):
    def sched(step: torch.Tensor) -> torch.Tensor:
        k = torch.div(step, every, rounding_mode="floor").float()
        return base * (drop ** k)

    return sched


def cdfl_decay(mu: float, a: float):
    """eta_k = 4 / (mu (a + k))  [Prop. 2; a >= 16 kappa]."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        return 4.0 / (mu * (a + step.float()))

    return sched
