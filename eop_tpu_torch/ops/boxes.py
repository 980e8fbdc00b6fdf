"""Box geometry (counterpart of ``eop_tpu/ops/boxes.py``).  The torch
functions take any number of leading batch dims; ``matrix_iou``,
``adjust_box_anns`` and ``filter_box`` are the data pipeline's numpy
helpers."""

from __future__ import annotations

import numpy as np
import torch


def cxcywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)


def xyxy2cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """[x1, y1, x2, y2] -> [cx, cy, w, h]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    w, h = x2 - x1, y2 - y1
    return torch.stack([x1 + w * 0.5, y1 + h * 0.5, w, h], dim=-1)


def xyxy2xywh(boxes: torch.Tensor) -> torch.Tensor:
    """[x1, y1, x2, y2] -> [x1, y1, w, h]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


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


def matrix_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes [Na, 4] x [Nb, 4] -> [Na, Nb], numpy."""
    overlap_lo = np.maximum(a[:, None, :2], b[None, :, :2])
    overlap_hi = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    side = np.clip(overlap_hi - overlap_lo, 0.0, None)
    inter = side[..., 0] * side[..., 1]

    def span(boxes):
        wh = boxes[:, 2:4] - boxes[:, :2]
        return wh[:, 0] * wh[:, 1]

    return inter / (span(a)[:, None] + span(b)[None, :] - inter + 1e-12)


def adjust_box_anns(bbox: np.ndarray, scale_ratio, padw, padh, w_max, h_max):
    """Scale, shift and clip the xyxy columns of ``bbox`` in place."""
    shift = np.asarray([padw, padh], dtype=np.float64)
    limit = np.asarray([w_max, h_max], dtype=np.float64)
    quad = bbox[:, :4].reshape(-1, 2, 2)
    bbox[:, :4] = np.clip(quad * scale_ratio + shift, 0.0, limit).reshape(-1, 4)
    return bbox


def filter_box(output: np.ndarray, scale_range) -> np.ndarray:
    """The detections whose area lies strictly inside ``scale_range`` squared."""
    lo, hi = scale_range
    wh = output[:, 2:4] - output[:, 0:2]
    area = wh[:, 0] * wh[:, 1]
    return output[(area > lo * lo) & (area < hi * hi)]
