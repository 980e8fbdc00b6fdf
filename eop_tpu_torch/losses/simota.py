"""SimOTA dynamic-k label assignment with static shapes (counterpart of
``eop_tpu/losses/simota.py``): the shared matcher, and the bbox family's
``in_boxes_info`` and ``simota_assign``.

The JAX package made every shape static for XLA: labels stay padded to
``max_labels`` with a ``gt_valid`` mask, the candidate gather is an additive
cost penalty plus a gate, per-GT ``topk(cost, dynamic_k)`` is a top-``max_k``
and a ``rank < k`` mask, and the dedup pass is a select.  On the card the
same form keeps the training step free of host synchronisation: nothing here
calls ``nonzero``, ``.item()`` or indexes with a boolean mask.  Where JAX
vmaps over images, every function here takes a leading batch dimension.

Tie order follows JAX: ``jnp.argmax`` / ``argmin`` return the first index
among equals and ``lax.top_k`` keeps the lower index first, which
``torch.argmax`` and ``torch.topk`` do not promise on the card, so ties are
resolved by explicit first-index constructions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.boxes import bboxes_iou

BIG_COST = 1e6  # disqualifies non-candidate anchors / invalid GTs
CENTER_RADIUS = 2.5
MAX_K = 10
CAND_CAP = 1536  # static capacity of the compacted candidate-anchor set


class SimOTAConfig(NamedTuple):
    center_radius: float = CENTER_RADIUS
    max_k: int = MAX_K
    iou_weight: float = 3.0
    # The expensive pairwise stages run on the first ``cand_cap`` candidate
    # anchors instead of all A.  Bit-exact while the candidates fit; on
    # overflow low-priority anchors are shed and reported (``cand_dropped``).
    # 0 disables compaction (full-lattice path).
    cand_cap: int = CAND_CAP


class Assignment(NamedTuple):
    """Per-image assignment over the A anchors, batched."""

    fg_mask: torch.Tensor      # bool [B, A]
    matched_gt: torch.Tensor   # int64 [B, A], gt index (0 where ~fg)
    pred_iou: torch.Tensor     # f32 [B, A], matched similarity (0 where ~fg)
    num_fg: torch.Tensor       # f32 [B]
    num_gt: torch.Tensor       # f32 [B]
    num_dropped: Optional[torch.Tensor] = None  # int64 [B], shed candidates


class NormalisedLosses(NamedTuple):
    """A loss's component sums over the foreground divided by ``num_fg``
    (:func:`normalised_losses`)."""

    losses: tuple            # differentiable, for the backward
    values: tuple            # detached: the batch's losses
    num_fg: torch.Tensor     # clamped at 1
    num_gts: torch.Tensor    # clamped at 1
    cand_dropped: torch.Tensor


def normalised_losses(sums, assign: Assignment,
                      group=None) -> NormalisedLosses:
    """Each of ``sums`` (a loss's sums over this batch's anchors) divided by
    the batch's foreground count.  With a process ``group`` the batch is the
    global one of every rank's rows, as under ``eop_tpu``'s sharded step:
    ``num_fg``, ``num_gts``, the dropped candidates and the sums are summed
    over the ranks (one ``all_reduce``) and ``values`` are the global
    losses, while ``losses`` are this rank's sums times the world size over
    the global ``num_fg``: their gradients, averaged over the ranks, are
    the global losses' gradients."""
    if group is None:
        num_fg = assign.num_fg.sum().clamp(min=1.0)
        num_gts = assign.num_gt.sum().clamp(min=1.0)
        losses = tuple(s / num_fg for s in sums)
        return NormalisedLosses(losses, tuple(v.detach() for v in losses),
                                num_fg, num_gts, assign.num_dropped.sum())
    from ..parallel.dist import all_reduce_sum

    dropped = assign.num_dropped.sum()
    fg, gts, dropped_all, *totals = all_reduce_sum(
        [assign.num_fg.sum(), assign.num_gt.sum(), dropped, *sums], group)
    world = torch.distributed.get_world_size(group)
    num_fg = fg.to(assign.num_fg.dtype).clamp(min=1.0)
    num_gts = gts.to(assign.num_gt.dtype).clamp(min=1.0)
    losses = tuple(s * world / num_fg for s in sums)
    values = tuple((t / num_fg).to(s.dtype) for t, s in zip(totals, sums))
    return NormalisedLosses(losses, values, num_fg, num_gts,
                            dropped_all.round().to(dropped.dtype))


def _first_index(hit: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (size of ``dim`` where none)."""
    n = hit.shape[dim]
    shape = [1] * hit.dim()
    shape[dim] = n
    ar = torch.arange(n, device=hit.device).reshape(shape)
    return torch.where(hit, ar, n).amin(dim=dim)


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.argmax``: the first index among equal maxima."""
    n = x.shape[dim]
    top = x.amax(dim=dim, keepdim=True)
    return _first_index(x == top, dim).clamp(max=n - 1)


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.argmin``: the first index among equal minima."""
    return first_argmax(-x, dim)


def _top_by_score(score: torch.Tensor, k: int):
    """Top ``k`` of integer ``score`` [B, A], descending, the lower index
    first within one score (``lax.top_k``'s order): the keys
    ``score * (A + 1) - index`` are distinct, so any top-k agrees."""
    a = score.shape[-1]
    key = score.long() * (a + 1) - torch.arange(a, device=score.device)
    return torch.topk(key, k, dim=-1)


def compact_candidates(score: torch.Tensor, cap: int):
    """Static-capacity compaction of a scored candidate set.

    ``score`` [B, A] integer: 0 = no candidate, higher = keep first; ties
    keep the lower anchor index.  Returns (idx [B, cap] anchor per slot, 0
    at unused slots; valid [B, cap] bool; n_dropped [B] candidates beyond
    the capacity)."""
    vals, idx = _top_by_score(score, cap)
    valid = vals > 0  # score >= 1 gives key >= (A + 1) - A = 1
    n_dropped = ((score > 0).sum(dim=-1) - cap).clamp(min=0)
    return torch.where(valid, idx, 0), valid, n_dropped


def scatter_assignment(idx, valid, a: int, fg_k, matched_k, pred_iou_k):
    """Scatter per-slot results [B, cap] back to the full lattice [B, A].
    Valid slots hold distinct anchors; the others go to a column that is
    dropped."""
    b = idx.shape[0]
    safe = torch.where(valid, idx, a)

    def scatter(values):
        out = values.new_zeros((b, a + 1))
        return out.scatter_(1, safe, values)[:, :a]

    return (scatter(fg_k & valid), scatter(matched_k),
            scatter(torch.where(valid, pred_iou_k, 0.0)))


def gather_foreground(assign: Assignment, max_labels: int, max_k: int):
    """Static foreground compaction: SimOTA selects at most ``max_labels *
    max_k`` anchors per image, so the matched losses run on a [B, K] gather
    instead of all A anchors, with 0/1 weights ``w_fg`` zeroing the padding.

    Returns (w_fg [B, K] f32, fg_idx [B, K], matched [B, K],
    pred_iou [B, K])."""
    fg = assign.fg_mask
    k_fg = min(fg.shape[1], max_labels * max_k)
    _, fg_idx = _top_by_score(fg, k_fg)
    w_fg = fg.gather(1, fg_idx).float()
    matched = assign.matched_gt.gather(1, fg_idx)
    pred_iou_k = assign.pred_iou.gather(1, fg_idx)
    return w_fg, fg_idx, matched, pred_iou_k


def gather_anchor_geometry(grids, strides, fg_idx):
    """Grid cells [A, 2] and strides [A] at the compacted indices [B, K]
    -> [B, K, 2], [B, K]."""
    return grids[fg_idx], strides[fg_idx]


def pairwise_cls_cost(cls_logits, obj_logits, gt_classes, num_classes: int):
    """``sqrt(sigmoid(cls) * sigmoid(obj))`` BCE against the one-hot GT
    class, summed over classes, in fp32: cls_logits [B, A, C], obj_logits
    [B, A], gt_classes [B, M] -> [B, M, A]."""
    p = torch.sqrt(torch.sigmoid(cls_logits.float())
                   * torch.sigmoid(obj_logits.float())[..., None])
    classes = torch.arange(num_classes, device=p.device)
    onehot = (gt_classes.long()[..., None] == classes).float()  # [B, M, C]
    # torch.binary_cross_entropy clamps each log term at -100
    log_p = torch.log(p).clamp(min=-100.0)
    log_1p = torch.log(1.0 - p).clamp(min=-100.0)
    pos = onehot @ log_p.transpose(-1, -2)
    neg = (1.0 - onehot) @ log_1p.transpose(-1, -2)
    return -(pos + neg)


def topk_small(x: torch.Tensor, k: int):
    """Top-k along the last axis by k rounds of (first argmax, mask out):
    values and indices [..., k] in descending order, the first index among
    equals, as the JAX function returns them."""
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        i = first_argmax(cur, -1)
        vals.append(cur.gather(-1, i[..., None])[..., 0])
        idxs.append(i)
        cur = cur.scatter(-1, i[..., None], float("-inf"))
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def simota_match(cost, pair_iou, is_candidate, gt_valid, max_k: int = MAX_K):
    """Core dynamic-k matcher, static shapes.

    cost [B, M, A] (candidate and validity penalties included); pair_iou
    [B, M, A] similarity; is_candidate [B, M, A] bool; gt_valid [B, M].
    Returns (matching [B, M, A] bool, fg_mask [B, A], matched_gt [B, A],
    pred_iou [B, A], num_fg [B] f32)."""
    m, a = cost.shape[-2:]
    k_cand = min(max_k, a)

    # dynamic k per gt: sum of the top-10 candidate similarities, truncated
    iou_cand = torch.where(is_candidate, pair_iou, 0.0)
    topk_ious = torch.topk(iou_cand, k_cand, dim=-1).values
    dynamic_k = topk_ious.sum(dim=-1).to(torch.int64).clamp(1, k_cand)

    # per-gt top-k cheapest anchors
    _, topk_idx = topk_small(-cost, k_cand)  # [B, M, k], distinct per row
    rank = torch.arange(k_cand, device=cost.device)
    sel = rank < dynamic_k[..., None]
    sel = sel & is_candidate.expand_as(cost).gather(-1, topk_idx)
    sel = sel & gt_valid[..., None]
    matching = torch.zeros_like(cost, dtype=torch.bool).scatter_(
        -1, topk_idx, sel)

    # dedup: an anchor claimed by more than one gt goes to the cheapest
    col_sum = matching.sum(dim=-2)
    cost_argmin = first_argmin(cost, dim=-2)  # [B, A]
    gts = torch.arange(m, device=cost.device)[:, None]
    winner = gts == cost_argmin[..., None, :]
    claimed = matching.any(dim=-2)
    matching = torch.where((col_sum > 1)[..., None, :],
                           winner & claimed[..., None, :], matching)

    fg_mask = matching.any(dim=-2)
    matched_gt = torch.where(fg_mask, _first_index(matching, -2), 0)
    pred_iou = torch.where(matching, pair_iou, 0.0).sum(dim=-2)
    num_fg = fg_mask.sum(dim=-1).float()
    return matching, fg_mask, matched_gt, pred_iou, num_fg


def in_boxes_info(gt_boxes, gt_valid, grids, strides, center_radius: float):
    """Anchor-centre membership: gt_boxes [B, M, 4] cxcywh, gt_valid [B, M],
    grids [A, 2], strides [A] -> (is_in_boxes, is_in_centers) [B, M, A],
    False at invalid GTs."""
    x_c = (grids[:, 0] + 0.5) * strides  # [A]
    y_c = (grids[:, 1] + 0.5) * strides
    cx, cy = gt_boxes[..., 0:1], gt_boxes[..., 1:2]  # [B, M, 1]
    hw, hh = 0.5 * gt_boxes[..., 2:3], 0.5 * gt_boxes[..., 3:4]
    d = torch.stack([x_c - (cx - hw), y_c - (cy - hh), (cx + hw) - x_c,
                     (cy + hh) - y_c], dim=-1)
    is_in_boxes = d.amin(dim=-1) > 0.0
    r = center_radius * strides
    cd = torch.stack([x_c - (cx - r), y_c - (cy - r), (cx + r) - x_c,
                      (cy + r) - y_c], dim=-1)
    is_in_centers = cd.amin(dim=-1) > 0.0
    valid = gt_valid[..., None]
    return is_in_boxes & valid, is_in_centers & valid


def gather_anchors(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[b, idx[b, j]]`` for ``t`` [B, A, ...] and ``idx`` [B, K]."""
    extra = t.dim() - 2
    ix = idx.reshape(idx.shape + (1,) * extra).expand(
        idx.shape + t.shape[2:])
    return t.gather(1, ix)


def simota_assign(labels, bbox_preds, obj_logits, cls_logits, grids, strides,
                  num_classes: int, config: SimOTAConfig) -> Assignment:
    """SimOTA for the bbox head over a batch: labels [B, M, 5] rows (cls, cx,
    cy, w, h) zero-padded, bbox_preds [B, A, 4] decoded cxcywh, obj_logits
    [B, A], cls_logits [B, A, C], grids [A, 2], strides [A].

    With ``config.cand_cap`` below A the pairwise stages run on the
    compacted candidates, centre-box anchors ranked first; they equal the
    full lattice's while the candidates fit."""
    gt_valid = labels.sum(dim=-1) > 0
    gt_boxes, gt_classes = labels[..., 1:5], labels[..., 0]
    in_boxes, in_centers = in_boxes_info(gt_boxes, gt_valid, grids, strides,
                                         config.center_radius)
    b, a = bbox_preds.shape[:2]
    m = gt_boxes.shape[1]
    valid = gt_valid[..., None]

    def assign_core(bbox_p, obj_l, cls_l, in_b, in_c, is_candidate):
        in_both = in_b & in_c
        pair_iou = torch.where(valid, bboxes_iou(gt_boxes, bbox_p, xyxy=False),
                               0.0)
        iou_cost = -torch.log(pair_iou + 1e-8)
        cls_cost = pairwise_cls_cost(cls_l, obj_l, gt_classes, num_classes)
        cost = (cls_cost
                + config.iou_weight * iou_cost
                + 100000.0 * (~in_both)
                + BIG_COST * (~is_candidate)
                + BIG_COST * (~valid))
        return simota_match(cost, pair_iou, is_candidate, gt_valid,
                            config.max_k)

    cap = config.cand_cap
    num_gt = gt_valid.sum(dim=-1).float()
    if cap and cap < a:
        score = 2 * in_centers.any(dim=1).long() + in_boxes.any(dim=1).long()
        idx, cand_valid, num_dropped = compact_candidates(score, cap)
        keep = cand_valid[:, None, :]
        cols = idx[:, None, :].expand(b, m, cap)
        _, fg_k, matched_k, pred_iou_k, num_fg = assign_core(
            gather_anchors(bbox_preds, idx), gather_anchors(obj_logits, idx),
            gather_anchors(cls_logits, idx), in_boxes.gather(2, cols) & keep,
            in_centers.gather(2, cols) & keep, keep.expand(b, m, cap))
        fg_mask, matched_gt, pred_iou = scatter_assignment(
            idx, cand_valid, a, fg_k, matched_k, pred_iou_k)
        return Assignment(fg_mask, matched_gt, pred_iou, num_fg, num_gt,
                          num_dropped)
    fg_candidate = (in_boxes.any(dim=1) | in_centers.any(dim=1))[:, None, :]
    _, fg_mask, matched_gt, pred_iou, num_fg = assign_core(
        bbox_preds, obj_logits, cls_logits, in_boxes, in_centers,
        fg_candidate.expand(b, m, a))
    return Assignment(fg_mask, matched_gt, pred_iou, num_fg, num_gt,
                      torch.zeros(b, dtype=torch.int64,
                                  device=fg_mask.device))
