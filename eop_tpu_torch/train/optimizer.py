"""Optimizer construction (counterpart of ``eop_tpu/train/optimizer.py``).

Nesterov SGD with momentum 0.9.  Weight decay applies to conv kernels only:
BatchNorm scales and every bias get none (the reference's three parameter
groups).  optax adds the decayed weights to the gradient before the momentum
trace, which is what torch's coupled ``weight_decay`` does; the 24p default
is 0.  The update itself is the same in both: ``buf = mu * buf + g``,
``p -= lr * (g + mu * buf)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn as nn


class SGD(torch.optim.SGD):
    """``torch.optim.SGD`` with optional global-norm gradient clipping before
    the update and an optional iteration schedule: ``lr_schedule(step)`` is
    the learning rate the train step sets before update number ``step``
    (0-based)."""

    def __init__(self, params, lr: float,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 clip_grad_norm: float = 0.0, **kwargs):
        super().__init__(params, lr=lr, **kwargs)
        self.lr_schedule = lr_schedule
        self.clip_grad_norm = clip_grad_norm

    def set_lr(self, step: int) -> None:
        if self.lr_schedule is not None:
            lr = float(self.lr_schedule(step))
            for group in self.param_groups:
                group["lr"] = lr

    def step(self, closure=None):
        if self.clip_grad_norm and self.clip_grad_norm > 0:
            params = [p for g in self.param_groups for p in g["params"]]
            nn.utils.clip_grad_norm_(params, self.clip_grad_norm)
        return super().step(closure)


def build_sgd(model: nn.Module,
              learning_rate: Union[float, Callable[[int], float]],
              momentum: float = 0.9, weight_decay: float = 0.0,
              nesterov: bool = True, clip_grad_norm: float = 0.0) -> SGD:
    """SGD over ``model``'s parameters; ``learning_rate`` may be an iteration
    schedule.  ``clip_grad_norm > 0`` adds global-norm gradient clipping (off
    by default)."""
    kernels = [p for p in model.parameters() if p.dim() == 4]
    others = [p for p in model.parameters() if p.dim() != 4]
    schedule = learning_rate if callable(learning_rate) else None
    lr = float(schedule(0)) if schedule is not None else float(learning_rate)
    groups = [{"params": kernels, "weight_decay": weight_decay},
              {"params": others, "weight_decay": 0.0}]
    return SGD(groups, lr=lr, lr_schedule=schedule,
               clip_grad_norm=clip_grad_norm, momentum=momentum,
               nesterov=nesterov)
