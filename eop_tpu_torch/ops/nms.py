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
