"""Elementwise losses (counterpart of ``eop_tpu/losses/iou_loss.py``): the
matched-pair bbox IoU / GIoU loss and BCE with logits; reductions are the
caller's."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise binary cross entropy on logits
    (``BCEWithLogitsLoss(reduction="none")``), in the JAX package's form."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _corners(boxes: torch.Tensor):
    half = boxes[..., 2:4] * 0.5
    return boxes[..., :2] - half, boxes[..., :2] + half


def _box_area(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.prod(hi - lo, dim=-1)


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             loss_type: str = "iou") -> torch.Tensor:
    """Matched-pair loss on cxcywh boxes ``[..., 4]`` -> ``[...]``:
    ``1 - iou**2`` (``"iou"``) or ``1 - giou`` (``"giou"``)."""
    (p_lo, p_hi), (g_lo, g_hi) = _corners(pred), _corners(target)
    lo, hi = torch.maximum(p_lo, g_lo), torch.minimum(p_hi, g_hi)
    nonempty = torch.all(lo < hi, dim=-1).to(pred.dtype)
    area_i = _box_area(lo, hi) * nonempty
    area_u = (torch.prod(pred[..., 2:4], dim=-1)
              + torch.prod(target[..., 2:4], dim=-1) - area_i)
    iou = area_i / (area_u + 1e-16)
    if loss_type == "iou":
        return 1.0 - iou ** 2
    if loss_type == "giou":
        area_c = _box_area(torch.minimum(p_lo, g_lo),
                           torch.maximum(p_hi, g_hi))
        giou = iou - (area_c - area_u) / torch.clamp(area_c, min=1e-16)
        return 1.0 - torch.clamp(giou, -1.0, 1.0)
    raise ValueError(f"unknown loss_type {loss_type!r}")
