"""Model EMA as explicit train state (counterpart of
``eop_tpu/train/ema.py``): an average over parameters and BatchNorm running
statistics with the ramped decay ``d * (1 - exp(-updates / 2000))``."""

from __future__ import annotations

import math
from typing import Dict

import torch


def ema_decay_at(updates: int, decay: float = 0.9998) -> float:
    return decay * (1.0 - math.exp(-updates / 2000.0))


def _like(p: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``p`` in ``e``'s dtype and, where ``e`` is sharded (a ``DTensor``
    under FSDP) and ``p`` is whole on every rank (a BatchNorm buffer), this
    rank's shard of it."""
    p = p.to(e.dtype)
    if hasattr(e, "device_mesh") and not hasattr(p, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor

        p = distribute_tensor(p, e.device_mesh, e.placements,
                              src_data_rank=None)
    return p


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
               updates: int, decay: float = 0.9998) -> None:
    """One EMA step, in place on ``ema``: ``e = e * d + p * (1 - d)`` for
    every key.  ``updates`` is the 1-based update count."""
    d = ema_decay_at(updates, decay)
    es = list(ema.values())
    ps = [_like(new[k], e) for k, e in ema.items()]
    torch._foreach_mul_(es, d)
    torch._foreach_add_(es, ps, alpha=1.0 - d)
