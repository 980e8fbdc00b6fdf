"""Elementwise losses (counterpart of ``eop_tpu/losses/iou_loss.py``; the
bbox IoU loss waits for the bbox family)."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise binary cross entropy on logits
    (``BCEWithLogitsLoss(reduction="none")``), in the JAX package's form."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
