"""Box geometry (counterpart of ``eop_tpu/ops/boxes.py``); every function
takes any number of leading batch dims."""

from __future__ import annotations

import torch


def cxcywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)


def bboxes_iou(bboxes_a: torch.Tensor, bboxes_b: torch.Tensor,
               xyxy: bool = True) -> torch.Tensor:
    """Pairwise IoU ``[..., Na, Nb]``; ``xyxy=False`` reads [cx, cy, w, h]."""
    if xyxy:
        corners_a, corners_b = bboxes_a[..., :4], bboxes_b[..., :4]
        area_a = torch.prod(bboxes_a[..., 2:4] - bboxes_a[..., :2], dim=-1)
        area_b = torch.prod(bboxes_b[..., 2:4] - bboxes_b[..., :2], dim=-1)
    else:
        half_a, half_b = bboxes_a[..., 2:4] * 0.5, bboxes_b[..., 2:4] * 0.5
        corners_a = torch.cat([bboxes_a[..., :2] - half_a,
                               bboxes_a[..., :2] + half_a], dim=-1)
        corners_b = torch.cat([bboxes_b[..., :2] - half_b,
                               bboxes_b[..., :2] + half_b], dim=-1)
        area_a = torch.prod(bboxes_a[..., 2:4], dim=-1)
        area_b = torch.prod(bboxes_b[..., 2:4], dim=-1)
    tl = torch.maximum(corners_a[..., :, None, :2], corners_b[..., None, :, :2])
    br = torch.minimum(corners_a[..., :, None, 2:], corners_b[..., None, :, 2:])
    en = torch.all(tl < br, dim=-1).to(bboxes_a.dtype)
    area_i = torch.prod(br - tl, dim=-1) * en
    return area_i / (area_a[..., :, None] + area_b[..., None, :] - area_i)
