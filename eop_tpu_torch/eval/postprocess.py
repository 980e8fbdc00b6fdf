"""Batched 24p post-processing with static output capacity (counterpart of
``eop_tpu/eval/postprocess.py``, fused ``*_heads`` entry).

Every image yields exactly ``max_detections`` rows plus a validity mask,
computed for the whole batch at once (no per-image Python loop):
score -> top-k candidates -> decode only the candidates -> polygon ->
enclosing rectangle -> exact fixpoint NMS -> score-ordered compaction.

Ties follow ``lax.top_k``: the lower anchor index comes first (a stable
descending sort), and the class argmax runs on the sigmoided fp32 values,
where it picks the first of equal maxima.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..models.head import flatten_head_outputs, make_grids_and_strides
from ..ops.nms import nms_on_candidates
from ..ops.polygon import polygon_points_from_radii


class Detections(NamedTuple):
    """Fixed-capacity detections: rows [B, max_det, D], valid [B, max_det]."""

    rows: torch.Tensor
    valid: torch.Tensor


def _select_rows(cand: torch.Tensor, keep: torch.Tensor, max_det: int):
    """Compact kept candidate rows ``[B, K, D]`` (already score-sorted) into
    the first ``max_det`` slots: each kept row goes to slot ``cumsum - 1``;
    dropped rows and any surplus past ``max_det`` go to an extra row that is
    cut off (the JAX scatter's ``mode="drop"``)."""
    b, k, d = cand.shape
    m = max_det
    dest = torch.where(keep, torch.cumsum(keep, dim=-1) - 1,
                       torch.full_like(keep, m, dtype=torch.long))
    dest = dest.clamp(max=m)
    flat_idx = (dest + torch.arange(b, device=cand.device)[:, None] * (m + 1))
    out = cand.new_zeros((b * (m + 1), d))
    out.index_copy_(0, flat_idx.reshape(-1), cand.reshape(-1, d))
    out = out.reshape(b, m + 1, d)[:, :m]
    n_kept = keep.sum(dim=-1, keepdim=True)
    valid = torch.arange(m, device=cand.device)[None] < n_kept.clamp(max=m)
    return out, valid


def _nms_and_pack(geom, boxes, top_scores, c_obj, c_cls_conf, c_cls_id,
                  conf_thre, nms_thre, class_agnostic, fixpoint_iters,
                  max_det):
    """NMS over the candidates, rows ``[geom | obj | cls_conf | cls_id]``,
    score-order compaction."""
    keep = nms_on_candidates(
        boxes, top_scores >= conf_thre, nms_thre,
        class_ids=None if class_agnostic else c_cls_id,
        fixpoint_iters=fixpoint_iters,
    )
    rows = torch.cat([geom, c_obj[..., None], c_cls_conf[..., None],
                      c_cls_id.to(geom.dtype)[..., None]], dim=-1)
    return _select_rows(rows, keep, max_det)


def _decoded_candidates(flat, grids, strides_flat, reg_dim: int,
                        num_classes: int, k: int):
    """Score -> top-k -> gather -> decode for the raw flattened head output
    ``flat [B, A, reg_dim+1+C]``.  Equal to decoding the full lattice first:
    scores come from the same fp32 logits and the grid decode is
    elementwise per anchor."""
    logits = flat[..., reg_dim:].float()
    obj = torch.sigmoid(logits[..., 0])
    cls_probs = torch.sigmoid(logits[..., 1:1 + num_classes])
    cls_conf, cls_id = torch.max(cls_probs, dim=-1)
    scores = obj * cls_conf
    top_scores, order = torch.sort(scores, dim=-1, descending=True,
                                   stable=True)
    k = min(k, flat.shape[1])
    top_scores, order = top_scores[:, :k], order[:, :k]
    cand = torch.gather(
        flat, 1, order[..., None].expand(-1, -1, flat.shape[-1])).float()
    s = strides_flat[order][..., None]
    xy = (cand[..., :2] + grids[order]) * s
    sizes = torch.exp(torch.clamp(cand[..., 2:reg_dim], -30.0, 30.0)) * s
    return (top_scores, xy, sizes, torch.gather(obj, 1, order),
            torch.gather(cls_conf, 1, order), torch.gather(cls_id, 1, order))


def _flatten_heads(head_outs, strides):
    flat = flatten_head_outputs(head_outs)
    grids, strides_flat = make_grids_and_strides(
        [tuple(o.shape[2:4]) for o in head_outs], strides, flat.device,
        torch.float32)
    return flat, grids, strides_flat


def postprocess_24p_heads(
    head_outs: Sequence[torch.Tensor],
    num_classes: int,
    conf_thre: float = 0.01,
    nms_thre: float = 0.3,
    class_agnostic: bool = False,
    max_detections: int = 300,
    nms_candidates: int = 512,
    reference_parity: bool = False,
    nms_fixpoint_iters=None,
    strides=(8, 16, 32),
) -> Detections:
    """Raw per-scale 24p head maps (NCHW) -> rows ``[B, max_det, 29]``:
    x, y, r1..r24, obj, cls_conf, cls."""
    flat, grids, strides_flat = _flatten_heads(head_outs, strides)
    top_scores, centers, radii, c_obj, c_cls_conf, c_cls_id = \
        _decoded_candidates(flat, grids, strides_flat, 26, num_classes,
                            nms_candidates)
    pts = polygon_points_from_radii(centers, radii, reference_parity)
    boxes = torch.cat([pts.amin(dim=-2), pts.amax(dim=-2)], dim=-1)
    rows, valid = _nms_and_pack(
        torch.cat([centers, radii], dim=-1), boxes, top_scores, c_obj,
        c_cls_conf, c_cls_id, conf_thre, nms_thre, class_agnostic,
        nms_fixpoint_iters, max_detections,
    )
    return Detections(rows=rows, valid=valid)
