"""The bbox family's training loss (counterpart of
``eop_tpu/losses/yolox_loss.py``): ``5 * IoU + obj + cls (+ L1)``, each term
summed over the foreground anchors SimOTA picks and divided by the batch's
``num_fg`` (the global batch's, with a process group).  Static shapes,
batched, no host synchronisation; all math in fp32."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .iou_loss import bce_with_logits, iou_loss
from .simota import (
    SimOTAConfig,
    gather_anchor_geometry,
    gather_anchors,
    gather_foreground,
    normalised_losses,
    simota_assign,
)


class YoloxLossConfig(NamedTuple):
    num_classes: int = 80
    reg_weight: float = 5.0
    use_l1: bool = False
    simota: SimOTAConfig = SimOTAConfig()


class YoloxLossAux(NamedTuple):
    loss_iou: torch.Tensor       # reg_weight * IoU loss
    loss_obj: torch.Tensor
    loss_cls: torch.Tensor
    loss_l1: torch.Tensor
    num_fg_per_gt: torch.Tensor  # num_fg / num_gts
    # candidate anchors shed by capacity compaction (0: the assignment
    # equals the full lattice's)
    cand_dropped: Optional[torch.Tensor] = None


def _l1_target(gt_boxes, grids, strides, eps: float = 1e-8):
    """Per-anchor L1 regression target in the head's raw parametrisation."""
    tx = gt_boxes[..., 0] / strides - grids[..., 0]
    ty = gt_boxes[..., 1] / strides - grids[..., 1]
    tw = torch.log(gt_boxes[..., 2] / strides + eps)
    th = torch.log(gt_boxes[..., 3] / strides + eps)
    return torch.stack([tx, ty, tw, th], dim=-1)


def yolox_losses(decoded, origin_reg, labels, grids, strides,
                 config: YoloxLossConfig, group=None):
    """decoded [B, A, 4+1+C] (decoded cxcywh, logit obj and cls), origin_reg
    [B, A, 4] raw regression (for L1), labels [B, M, 5] (cls, cx, cy, w, h)
    zero-padded, grids [A, 2], strides [A].  Returns (total loss,
    :class:`YoloxLossAux`).  With a process ``group`` the loss is the
    global batch's over every rank's rows, and the returned tensor
    backpropagates this rank's share times the world size, as
    ``loss_24p``'s."""
    c = config.num_classes
    # fp32 for fp32 and bf16 inputs; float64 stays float64 (a referee step)
    dtype = torch.promote_types(decoded.dtype, torch.float32)
    decoded = decoded.to(dtype)
    labels = labels.to(dtype)
    bbox_preds = decoded[..., :4]
    obj_logits = decoded[..., 4]
    cls_logits = decoded[..., 5:]

    # the assignment is not differentiated
    with torch.no_grad():
        assign = simota_assign(labels, bbox_preds, obj_logits, cls_logits,
                               grids, strides, c, config.simota)

    fgf = assign.fg_mask.float()

    w_fg, fg_idx, matched, pred_iou_k = gather_foreground(
        assign, labels.shape[1], config.simota.max_k)
    bbox_k = gather_anchors(bbox_preds, fg_idx)
    cls_logits_k = gather_anchors(cls_logits, fg_idx)
    gt_boxes = gather_anchors(labels[..., 1:5], matched)  # [B, K, 4]
    gt_cls = gather_anchors(labels[..., 0], matched)
    classes = torch.arange(c, device=decoded.device)
    cls_target = ((gt_cls.long()[..., None] == classes).float()
                  * pred_iou_k[..., None])

    sum_iou = (iou_loss(bbox_k, gt_boxes) * w_fg).sum()
    sum_obj = bce_with_logits(obj_logits, fgf).sum()
    sum_cls = (bce_with_logits(cls_logits_k, cls_target)
               * w_fg[..., None]).sum()
    if config.use_l1:
        grids_k, strides_k = gather_anchor_geometry(grids, strides, fg_idx)
        origin_k = gather_anchors(origin_reg.to(dtype), fg_idx)
        l1_t = _l1_target(gt_boxes, grids_k, strides_k)
        sum_l1 = ((origin_k - l1_t).abs() * w_fg[..., None]).sum()
    else:
        sum_l1 = decoded.new_zeros(())

    norm = normalised_losses((sum_iou, sum_obj, sum_cls, sum_l1), assign,
                             group)
    loss_iou, loss_obj, loss_cls, loss_l1 = norm.losses
    total = config.reg_weight * loss_iou + loss_obj + loss_cls + loss_l1
    if group is not None:
        # the global batch's loss, with this rank's gradient
        loss_iou, loss_obj, loss_cls, loss_l1 = norm.values
        value = config.reg_weight * loss_iou + loss_obj + loss_cls + loss_l1
        total = total + (value - total).detach()
    aux = YoloxLossAux(
        loss_iou=config.reg_weight * loss_iou,
        loss_obj=loss_obj,
        loss_cls=loss_cls,
        loss_l1=loss_l1,
        num_fg_per_gt=norm.num_fg / norm.num_gts,
        cand_dropped=norm.cand_dropped,
    )
    return total, aux
