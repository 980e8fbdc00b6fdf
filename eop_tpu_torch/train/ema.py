"""Model EMA as explicit train state (counterpart of
``eop_tpu/train/ema.py``): an average over parameters and BatchNorm running
statistics with the ramped decay ``d * (1 - exp(-updates / 2000))``."""

from __future__ import annotations

import math
from typing import Dict

import torch


def ema_decay_at(updates: int, decay: float = 0.9998) -> float:
    return decay * (1.0 - math.exp(-updates / 2000.0))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
               updates: int, decay: float = 0.9998) -> None:
    """One EMA step, in place on ``ema``: ``e = e * d + p * (1 - d)`` for
    every key.  ``updates`` is the 1-based update count."""
    d = ema_decay_at(updates, decay)
    es = list(ema.values())
    ps = [new[k].to(e.dtype) for k, e in ema.items()]
    torch._foreach_mul_(es, d)
    torch._foreach_add_(es, ps, alpha=1.0 - d)
