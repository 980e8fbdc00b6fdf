"""24-point detector training loss: polygon SimOTA, concentric-circle GIoU
and DWA dynamic task weighting (counterpart of
``eop_tpu/losses/loss_24p.py``).  Static shapes, batched, no host
synchronisation.

* label rows are ``[cls, cx, cy, 24 x (x, y)]`` (51 floats), zero-padded to
  ``max_labels`` rows;
* candidate anchors come from the angle-sum point-in-polygon test or the
  2.5-stride centre box;
* the SimOTA similarity is the pairwise circle-GIoU statistic
  (``ops.circle_iou.pairwise_circle_similarity``);
* the regression loss is a 24-vector, one circle-GIoU loss per ray;
* DWA: ratios against the previous step's losses, clipped to [0, 2], softmax
  with T = 20 over 26 terms, scaled by 26; the previous losses travel as an
  explicit :class:`DWAState`.

``Loss24PConfig(reference_parity=True)`` replicates two quirks of the
reference: the loss-as-IoU SimOTA statistic, and an L1 target that uses the
absolute point coordinates instead of centre-relative radii.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.circle_iou import (
    matched_circle_giou_loss,
    pairwise_circle_similarity,
)
from ..ops.polygon import pts_in_poly_from_labels, radii_from_points
from .iou_loss import bce_with_logits
from .simota import (
    BIG_COST,
    Assignment,
    SimOTAConfig,
    compact_candidates,
    gather_anchor_geometry,
    gather_anchors,
    gather_foreground,
    normalised_losses,
    pairwise_cls_cost,
    scatter_assignment,
    simota_match,
)


class Loss24PConfig(NamedTuple):
    num_classes: int = 80
    use_l1: bool = False
    dwa_temperature: float = 20.0
    reference_parity: bool = False  # replicate the GIoU-as-IoU SimOTA stat
    simota: SimOTAConfig = SimOTAConfig()


class DWAState(NamedTuple):
    """The previous step's losses for DWA."""

    last_iou: torch.Tensor  # [24]
    last_obj: torch.Tensor  # scalar
    last_cls: torch.Tensor  # scalar

    @classmethod
    def init(cls, device=None) -> "DWAState":
        return cls(last_iou=torch.ones(24, device=device),
                   last_obj=torch.ones((), device=device),
                   last_cls=torch.ones((), device=device))


class Loss24PAux(NamedTuple):
    loss_iou: torch.Tensor       # [24] weighted per-ray losses
    loss_obj: torch.Tensor
    loss_cls: torch.Tensor
    loss_l1: torch.Tensor
    num_fg_per_gt: torch.Tensor
    reg_w: torch.Tensor          # [24] DWA weights
    obj_w: torch.Tensor
    cls_w: torch.Tensor
    # candidate anchors shed by capacity compaction this step (0: the
    # assignment equals the full lattice's)
    cand_dropped: Optional[torch.Tensor] = None


def simota_assign_24p(labels_xy, gt_classes, gt_valid, poly_preds,
                      obj_logits, cls_logits, grids, strides,
                      config: Loss24PConfig) -> Assignment:
    """Polygon SimOTA for a batch: labels_xy [B, M, 50] rows (cx, cy,
    24 x (x, y)), gt_classes [B, M], gt_valid [B, M] bool, poly_preds
    [B, A, 26] decoded (cx, cy, 24 radii), obj_logits [B, A], cls_logits
    [B, A, C], grids [A, 2], strides [A]."""
    x_c = (grids[:, 0] + 0.5) * strides  # [A]
    y_c = (grids[:, 1] + 0.5) * strides

    gt_centers = labels_xy[..., 0:2]
    gt_radii = radii_from_points(labels_xy)
    cx, cy = labels_xy[..., 0:1], labels_xy[..., 1:2]  # [B, M, 1]

    def in_centers_of(xq, yq, rq):
        """xq, yq, rq [A'] or [B, A'] -> [B, M, A']."""
        xq, yq, rq = (v[..., None, :] for v in (xq, yq, rq))
        return ((xq > cx - rq) & (xq < cx + rq) & (yq > cy - rq)
                & (yq < cy + rq) & gt_valid[..., None])

    def exact_masks_and_sim(xq, yq, rq, preds):
        """The reference's three per-pair stages on a given anchor set."""
        in_poly = (pts_in_poly_from_labels(labels_xy, xq, yq)
                   & gt_valid[..., None])
        in_centers = in_centers_of(xq, yq, rq)
        pair_sim = pairwise_circle_similarity(
            gt_centers, gt_radii, preds[..., 0:2], preds[..., 2:26],
            reference_parity=config.reference_parity)
        return in_poly, in_centers, pair_sim

    b, a = poly_preds.shape[:2]
    r = config.simota.center_radius * strides
    cap = config.simota.cand_cap
    num_gt = gt_valid.sum(dim=-1).float()
    if cap and cap < a:
        # Static candidate compaction.  The exact candidate test, the
        # angle-sum point-in-polygon, is itself the expensive O(M A 24)
        # atan2 stage, so compaction keys off a cheap provable superset:
        # candidates lie in the padded bounding box or the centre box.  An
        # edge of length L subtends < L/d rad from distance >= d, so an
        # angle sum >= 350 degrees forces d <= perimeter / 6.108: pad the
        # box by that (+2 px of floating-point slack).
        px, py = labels_xy[..., 2::2], labels_xy[..., 3::2]
        ex = torch.roll(px, -1, dims=-1) - px
        ey = torch.roll(py, -1, dims=-1) - py
        perimeter = torch.sqrt(ex * ex + ey * ey).sum(dim=-1)
        pad = (perimeter / (350.0 * torch.pi / 180.0) + 2.0)[..., None]
        bx0, bx1 = px.amin(-1, keepdim=True), px.amax(-1, keepdim=True)
        by0, by1 = py.amin(-1, keepdim=True), py.amax(-1, keepdim=True)
        in_bbox = ((x_c >= bx0 - pad) & (x_c <= bx1 + pad)
                   & (y_c >= by0 - pad) & (y_c <= by1 + pad)
                   & gt_valid[..., None])
        # centre-box anchors rank first (SimOTA's 100000 penalty on anchors
        # outside it means matches come from them), so overflow sheds only
        # the padded-box tail
        score = (2 * in_centers_of(x_c, y_c, r).any(dim=1).long()
                 + in_bbox.any(dim=1).long())
        idx, valid, num_dropped = compact_candidates(score, cap)
        in_poly, in_centers, pair_sim = exact_masks_and_sim(
            x_c[idx], y_c[idx], r[idx],
            gather_anchors(poly_preds, idx))
        in_poly = in_poly & valid[:, None, :]
        in_centers = in_centers & valid[:, None, :]
        fg_candidate = in_poly.any(dim=1) | in_centers.any(dim=1)
        fg_k, matched_k, pred_iou_k, num_fg = _match_core_24p(
            pair_sim, in_poly, in_centers, fg_candidate[:, None, :],
            gather_anchors(obj_logits, idx),
            gather_anchors(cls_logits, idx), gt_classes,
            gt_valid, config)
        fg_mask, matched_gt, pred_iou = scatter_assignment(
            idx, valid, a, fg_k, matched_k, pred_iou_k)
        return Assignment(fg_mask, matched_gt, pred_iou, num_fg, num_gt,
                          num_dropped)

    in_poly, in_centers, pair_sim = exact_masks_and_sim(x_c, y_c, r,
                                                        poly_preds)
    fg_candidate = in_poly.any(dim=1) | in_centers.any(dim=1)
    fg_mask, matched_gt, pred_iou, num_fg = _match_core_24p(
        pair_sim, in_poly, in_centers, fg_candidate[:, None, :], obj_logits,
        cls_logits, gt_classes, gt_valid, config)
    return Assignment(fg_mask, matched_gt, pred_iou, num_fg, num_gt,
                      torch.zeros(b, dtype=torch.int64, device=fg_mask.device))


def _match_core_24p(pair_sim, in_poly, in_centers, is_candidate, obj_logits,
                    cls_logits, gt_classes, gt_valid, config):
    """Cost assembly and dynamic-k match over whatever anchor axis the
    inputs carry (full lattice or compacted candidates)."""
    in_both = in_poly & in_centers
    valid = gt_valid[..., None]
    pair_sim = torch.where(valid, pair_sim, 0.0)
    sim_cost = -torch.log(pair_sim + 1e-8)
    cls_cost = pairwise_cls_cost(cls_logits, obj_logits, gt_classes,
                                 config.num_classes)
    cost = (cls_cost
            + config.simota.iou_weight * sim_cost
            + 100000.0 * (~in_both)
            + BIG_COST * (~is_candidate)
            + BIG_COST * (~valid))
    _, fg_mask, matched_gt, pred_iou, num_fg = simota_match(
        cost, pair_sim, is_candidate, gt_valid, config.simota.max_k)
    return fg_mask, matched_gt, pred_iou, num_fg


def loss_24p(decoded, origin_reg, labels, grids, strides, dwa: DWAState,
             config: Loss24PConfig, group=None):
    """decoded [B, A, 26+1+C] (decoded cx, cy, radii; logit obj and cls),
    origin_reg [B, A, 26] raw regression (for L1), labels [B, M, 51]
    zero-padded, grids [A, 2], strides [A].

    Returns (total loss, :class:`Loss24PAux`, the new :class:`DWAState`).

    With a process ``group`` (this rank's rows of a global batch), the loss
    is the global batch's, as in ``eop_tpu``'s sharded step: ``num_fg`` and
    ``num_gts`` are summed over the ranks, and so are the component sums
    that the DWA weights, the metrics, the new DWA state and the returned
    value see; the returned tensor backpropagates this rank's share times
    the world size, so that averaging the gradients over the ranks gives
    the global batch's gradient (:func:`normalised_losses`).
    """
    decoded = decoded.float()
    labels = labels.float()
    poly_preds = decoded[..., :26]
    obj_logits = decoded[..., 26]
    cls_logits = decoded[..., 27:]

    gt_valid = labels.sum(dim=2) > 0  # [B, M]
    labels_xy = labels[..., 1:]
    gt_classes = labels[..., 0]

    with torch.no_grad():
        assign = simota_assign_24p(labels_xy, gt_classes, gt_valid,
                                   poly_preds, obj_logits, cls_logits, grids,
                                   strides, config)

    fgf = assign.fg_mask.float()

    # foreground compaction: the matched losses run on at most
    # max_labels * max_k anchors per image
    w_fg, fg_idx, matched, pred_iou_k = gather_foreground(
        assign, labels.shape[1], config.simota.max_k)
    poly_k = gather_anchors(poly_preds, fg_idx)     # [B, K, 26]
    gt_rows = gather_anchors(labels_xy, matched)    # [B, K, 50]
    gt_cls = gather_anchors(gt_classes, matched)    # [B, K]

    # --- per-ray circle-GIoU loss ("24 small tasks") ---
    gt_centers = gt_rows[..., 0:2]
    gt_radii = radii_from_points(gt_rows)
    per_ray = matched_circle_giou_loss(gt_centers, gt_radii, poly_k[..., 0:2],
                                       poly_k[..., 2:26])  # [B, K, 24]
    sum_iou = (per_ray * w_fg[..., None]).sum(dim=(0, 1))

    sum_obj = bce_with_logits(obj_logits, fgf).sum()
    cls_logits_k = gather_anchors(cls_logits, fg_idx)
    classes = torch.arange(config.num_classes, device=decoded.device)
    cls_target = ((gt_cls.long()[..., None] == classes).float()
                  * pred_iou_k[..., None])
    sum_cls = (bce_with_logits(cls_logits_k, cls_target)
               * w_fg[..., None]).sum()

    if config.use_l1:
        grids_k, strides_k = gather_anchor_geometry(grids, strides, fg_idx)
        origin_k = gather_anchors(origin_reg.float(), fg_idx)
        tx = gt_centers[..., 0] / strides_k - grids_k[..., 0]
        ty = gt_centers[..., 1] / strides_k - grids_k[..., 1]
        if config.reference_parity:
            # reference quirk: the per-ray "radius" is the distance from the
            # image origin to the polygon point, not from the object centre
            px, py = gt_rows[..., 2::2], gt_rows[..., 3::2]
            r_src = torch.sqrt(px * px + py * py)
        else:
            r_src = gt_radii
        tr = torch.log(r_src / strides_k[..., None] + 1e-8)
        l1_t = torch.cat([tx[..., None], ty[..., None], tr], dim=-1)
        sum_l1 = ((origin_k - l1_t).abs() * w_fg[..., None]).sum()
    else:
        sum_l1 = decoded.new_zeros(())

    sums = (sum_iou, sum_obj, sum_cls, sum_l1)
    norm = normalised_losses(sums, assign, group)
    loss_iou, loss_obj, loss_cls, loss_l1 = norm.losses
    li, lo, lc, l1 = norm.values

    # --- DWA weighting ---
    t = config.dwa_temperature
    e_iou = torch.exp(torch.clamp(li / (dwa.last_iou + 1e-8), 0.0, 2.0) / t)
    e_obj = torch.exp(torch.clamp(lo / (dwa.last_obj + 1e-8), 0.0, 2.0) / t)
    e_cls = torch.exp(torch.clamp(lc / (dwa.last_cls + 1e-8), 0.0, 2.0) / t)
    denom = e_iou.sum() + e_obj + e_cls
    reg_w = 26.0 * e_iou / denom
    obj_w = 26.0 * e_obj / denom
    cls_w = 26.0 * e_cls / denom

    total = ((reg_w * loss_iou).sum() + obj_w * loss_obj + cls_w * loss_cls
             + loss_l1)
    if group is not None:
        # the global batch's loss, with this rank's gradient
        value = (reg_w * li).sum() + obj_w * lo + cls_w * lc + l1
        total = total + (value - total).detach()
        loss_obj, loss_cls, loss_l1 = lo, lc, l1
    aux = Loss24PAux(
        loss_iou=reg_w * li,
        loss_obj=loss_obj,
        loss_cls=loss_cls,
        loss_l1=loss_l1,
        num_fg_per_gt=norm.num_fg / norm.num_gts,
        reg_w=reg_w,
        obj_w=obj_w,
        cls_w=cls_w,
        cand_dropped=norm.cand_dropped,
    )
    return total, aux, DWAState(last_iou=li, last_obj=lo, last_cls=lc)
