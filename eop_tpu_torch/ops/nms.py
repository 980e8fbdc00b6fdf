"""Static-capacity NMS over score-sorted candidates (counterpart of
``eop_tpu/ops/nms.py``), batched over leading dims.

Greedy NMS is computed as the fixpoint of
    F(keep)[j] = valid[j] and not exists i < j: keep[i] and iou[i, j] > t
which is unique and equals the greedy answer; each iteration is one
``[B, K, K]`` masked reduction.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .boxes import bboxes_iou


def _suppress(iou: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
              same_class: Optional[torch.Tensor] = None,
              fixpoint_iters: Union[int, str, None] = None) -> torch.Tensor:
    """Keep mask ``[..., K]`` of candidates sorted by descending score.

    ``fixpoint_iters`` ``"exact"`` (or None): iterate until no image of the
    batch changes, capped at K: greedy-exact for any suppression chain.
    An int fixes the number of iterations (exact only when it reaches the
    realized chain depth).
    """
    k = iou.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)
    overlap = (iou > iou_threshold) & upper  # i suppresses j only if i < j
    if same_class is not None:
        overlap &= same_class

    def apply_f(cur):
        suppressed = torch.any(overlap & cur[..., :, None], dim=-2)
        return valid & ~suppressed

    if fixpoint_iters is None or fixpoint_iters == "exact":
        cur = valid
        for _ in range(k):
            new = apply_f(cur)
            if torch.equal(new, cur):
                break
            cur = new
        return cur
    cur = valid
    for _ in range(min(int(fixpoint_iters), k)):
        cur = apply_f(cur)
    return cur


def nms_on_candidates(boxes: torch.Tensor, valid: torch.Tensor,
                      iou_threshold: float,
                      class_ids: Optional[torch.Tensor] = None,
                      fixpoint_iters: Union[int, str, None] = None
                      ) -> torch.Tensor:
    """NMS over candidates already sorted by descending score.

    boxes ``[..., K, 4]`` xyxy; valid ``[..., K]``; ``class_ids`` ``[..., K]``
    makes boxes of different classes never suppress each other
    (torchvision ``batched_nms`` semantics, as a same-class mask).
    Returns keep ``[..., K]``.
    """
    iou = bboxes_iou(boxes, boxes, xyxy=True)
    same = (None if class_ids is None
            else class_ids[..., :, None] == class_ids[..., None, :])
    return _suppress(iou, valid, iou_threshold, same_class=same,
                     fixpoint_iters=fixpoint_iters)


def _top_candidates(scores: torch.Tensor, max_candidates: Optional[int]):
    """``lax.top_k`` over the last axis: descending, the lower index first
    among equal scores."""
    n = scores.shape[-1]
    k = n if max_candidates is None else min(max_candidates, n)
    top, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top[..., :k], order[..., :k]


def _gather_rows(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``t[..., order[..., j], :]`` for ``t`` [..., N, D]."""
    idx = order[..., None].expand(*order.shape, t.shape[-1])
    return torch.gather(t, -2, idx)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        score_threshold: float = 0.0, max_candidates: Optional[int] = None,
        fixpoint_iters: Union[int, str, None] = None):
    """Class-agnostic NMS with static shapes: boxes [..., N, 4] xyxy, scores
    [..., N].  Candidates scoring below ``score_threshold`` are invalid (``>=``
    keeps).  Returns (keep [..., K], order [..., K]): ``keep[j]`` says
    whether candidate ``order[j]`` (an index into N) survives."""
    top, order = _top_candidates(scores, max_candidates)
    keep = nms_on_candidates(_gather_rows(boxes, order),
                             top >= score_threshold, iou_threshold,
                             fixpoint_iters=fixpoint_iters)
    return keep, order


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor,
                      class_ids: torch.Tensor, iou_threshold: float,
                      score_threshold: float = 0.0,
                      max_candidates: Optional[int] = None,
                      fixpoint_iters: Union[int, str, None] = None):
    """Per-class NMS (torchvision ``batched_nms`` semantics) as a same-class
    mask on the suppression matrix, not by offsetting each class's
    coordinates: with exp-decoded boxes one huge box would collapse a class
    onto a single fp32 value.  Returns (keep, order) as :func:`nms`."""
    top, order = _top_candidates(scores, max_candidates)
    keep = nms_on_candidates(_gather_rows(boxes, order),
                             top >= score_threshold, iou_threshold,
                             class_ids=torch.gather(class_ids, -1, order),
                             fixpoint_iters=fixpoint_iters)
    return keep, order
