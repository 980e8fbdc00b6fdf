"""Numpy deploy helpers (counterpart of ``eop_tpu/utils/demo_utils.py``):
greedy NMS with no dependency beyond numpy, class-aware and class-agnostic
multiclass NMS, and the flat-grid decoder of raw exported model outputs.

NMS builds the whole pairwise-overlap matrix once and walks a mask of the
live candidates; the decode grid comes from ``divmod`` over the flat
anchor indices.  Keep lists equal ``eop_tpu``'s for any scores (ties keep
``np.argsort``'s order, as there).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["mkdir", "nms", "multiclass_nms", "demo_postprocess"]


def mkdir(path):
    os.makedirs(path, exist_ok=True)


def _overlap_matrix(boxes):
    """[N, N] pairwise IoU under the legacy +1 (inclusive-pixel) area
    convention the deploy path has always used."""
    lo = np.maximum(boxes[:, None, :2], boxes[None, :, :2])
    hi = np.minimum(boxes[:, None, 2:4], boxes[None, :, 2:4])
    side = np.clip(hi - lo + 1.0, 0.0, None)
    inter = side[..., 0] * side[..., 1]
    ext = boxes[:, 2:4] - boxes[:, :2] + 1.0
    area = ext[:, 0] * ext[:, 1]
    return inter / (area[:, None] + area[None, :] - inter)


def nms(boxes, scores, nms_thr):
    """Greedy single-class NMS; returns kept indices in score order."""
    iou = _overlap_matrix(np.asarray(boxes, dtype=np.float64))
    rank = np.argsort(np.asarray(scores))[::-1]
    live = np.ones(len(rank), dtype=bool)
    keep = []
    for i in rank:
        if not live[i]:
            continue
        keep.append(int(i))
        live &= iou[i] <= nms_thr
        live[i] = False
    return keep


def _det_rows(boxes, scores, classes):
    """Stack kept detections as [x1, y1, x2, y2, score, cls] rows."""
    return np.concatenate(
        [boxes, scores[:, None], np.asarray(classes, np.float64)[:, None]],
        axis=1,
    )


def multiclass_nms(boxes, scores, nms_thr, score_thr, class_agnostic=True):
    """Multiclass NMS over ``scores[N, C]``; ``None`` when nothing passes."""
    if class_agnostic:
        return multiclass_nms_class_agnostic(boxes, scores, nms_thr, score_thr)
    return multiclass_nms_class_aware(boxes, scores, nms_thr, score_thr)


def multiclass_nms_class_aware(boxes, scores, nms_thr, score_thr):
    """Suppression runs independently per class column."""
    per_class = []
    for c in range(scores.shape[1]):
        col = scores[:, c]
        picked = np.flatnonzero(col > score_thr)
        if picked.size == 0:
            continue
        keep = picked[nms(boxes[picked], col[picked], nms_thr)]
        if keep.size:
            per_class.append(
                _det_rows(boxes[keep], col[keep], np.full(keep.size, c))
            )
    return np.concatenate(per_class, axis=0) if per_class else None


def multiclass_nms_class_agnostic(boxes, scores, nms_thr, score_thr):
    """One suppression pass on each box's best class."""
    best_cls = scores.argmax(axis=1)
    best_score = np.take_along_axis(
        scores, best_cls[:, None], axis=1
    ).ravel()
    picked = np.flatnonzero(best_score > score_thr)
    if picked.size == 0:
        return None
    keep = picked[nms(boxes[picked], best_score[picked], nms_thr)]
    if keep.size == 0:
        return None
    return _det_rows(boxes[keep], best_score[keep], best_cls[keep])


def _anchor_lattice(img_size, strides):
    """Flat (cx_index, cy_index, stride) columns for every anchor across the
    FPN levels, in level-major row-major order."""
    cols = []
    for s in strides:
        h, w = img_size[0] // s, img_size[1] // s
        ys, xs = np.divmod(np.arange(h * w), w)
        cols.append(np.stack([xs, ys, np.full(h * w, s)], axis=1))
    return np.concatenate(cols, axis=0)


def demo_postprocess(outputs, img_size, p6=False):
    """Decode raw exported outputs in place: xy = (pred + grid) * stride,
    wh = exp(pred) * stride; trailing channels pass through untouched."""
    lattice = _anchor_lattice(img_size, (8, 16, 32, 64) if p6 else (8, 16, 32))
    stride = lattice[None, :, 2:3]
    outputs[..., :2] = (outputs[..., :2] + lattice[None, :, :2]) * stride
    outputs[..., 2:4] = np.exp(outputs[..., 2:4]) * stride
    return outputs
