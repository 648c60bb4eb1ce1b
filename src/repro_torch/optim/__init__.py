"""Optimizers and learning-rate schedules on stacked per-node parameters."""
from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm, momentum_sgd,
                                          sgd)
from repro_torch.optim.schedules import (cdfl_decay, constant, cosine_decay,
                                         step_decay, warmup_cosine)

__all__ = ["Optimizer", "sgd", "momentum_sgd", "adamw", "apply_updates",
           "clip_by_global_norm", "constant", "cosine_decay",
           "warmup_cosine", "step_decay", "cdfl_decay"]
