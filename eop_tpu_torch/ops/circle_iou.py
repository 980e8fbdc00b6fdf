"""Concentric-circle intersection and GIoU: the 24-point detector's metric
(counterpart of ``eop_tpu/ops/circle_iou.py``).

Each of the 24 radial distances is a circle centred on the object centre;
prediction and ground truth are compared circle by circle with a GIoU.
Every branch is a ``torch.where`` select, so the functions broadcast over
any leading shape: matched pairs ``[N, 24]`` and the SimOTA pairwise block
``[..., G, P, 24]`` share the code and no shape depends on the data.

Pinned quirks of the reference (they shape training): acos arguments are
clipped to +-0.99, not +-1; where a pair is both "contained" and "disjoint",
disjoint wins; eps 1e-8 in the denominators, 1e-6 in the IoU.

The reference's pairwise SimOTA statistic is ``mean(1 - giou) / 2``, a loss,
which it then treats as an IoU.  ``pairwise_circle_similarity(...,
reference_parity=True)`` reproduces that; the default is the corrected
similarity ``(1 + mean(giou)) / 2`` in [0, 1].
"""

from __future__ import annotations

import math

import torch


def circle_inter(dist, r_a, r_b):
    """Intersection area of two circles at centre distance ``dist``; the
    arguments broadcast elementwise."""
    min_r = torch.minimum(r_a, r_b)
    max_r = torch.maximum(r_a, r_b)

    ac_min = (min_r ** 2 + dist ** 2 - max_r ** 2) / (2.0 * min_r * dist + 1e-8)
    ac_max = (max_r ** 2 + dist ** 2 - min_r ** 2) / (2.0 * max_r * dist + 1e-8)
    ac_min = torch.clamp(ac_min, -0.99, 0.99)
    ac_max = torch.clamp(ac_max, -0.99, 0.99)

    ang_min = torch.acos(ac_min)
    ang_max = torch.acos(ac_max)

    # sin(acos(x)) = sqrt(1 - x^2), well conditioned under the clip above
    sin_min = torch.sqrt(torch.clamp(1.0 - ac_min * ac_min, min=0.0))
    inter = (ang_min * min_r ** 2 + ang_max * max_r ** 2
             - min_r * dist * sin_min)

    contained = (r_a - r_b).abs() >= dist  # small circle inside the big one
    disjoint = dist >= r_a + r_b           # no overlap (wins over contained)

    res = torch.where(contained, math.pi * min_r ** 2, inter)
    return torch.where(disjoint, torch.zeros_like(res), res)


def circle_giou_24(dist, r_gt, r_pd):
    """Per-circle GIoU; arguments broadcast, typically ``dist [N, 1]``
    against radii ``[N, 24]``.  The training loss is ``1 - giou``."""
    area_gt = math.pi * r_gt ** 2
    area_pd = math.pi * r_pd ** 2
    inter = circle_inter(dist, r_gt, r_pd)
    union = area_gt + area_pd - inter
    iou = inter / (union + 1e-6)

    # enclosing circle: half the (r1 + r2 + d) chord, or the larger radius
    # when one circle contains the other
    contained = (r_gt - r_pd).abs() >= dist
    max_r = torch.maximum(r_gt, r_pd)
    c_l = torch.where(contained, max_r, (r_gt + r_pd + dist) * 0.5)
    c_s = math.pi * c_l ** 2
    return iou - (c_s - union) / c_s


def matched_circle_giou_loss(gt_centers, gt_radii, pd_centers, pd_radii):
    """``1 - giou`` per ray for matched rows: centres ``[N, 2]``, radii
    ``[N, 24]`` -> ``[N, 24]``.  This path is differentiated: the 1e-9 under
    the root keeps its gradient finite when a predicted centre lands exactly
    on the ground-truth centre."""
    dist = torch.sqrt(
        ((gt_centers - pd_centers) ** 2).sum(dim=-1, keepdim=True) + 1e-9)
    return 1.0 - circle_giou_24(dist, gt_radii, pd_radii)


def pairwise_circle_giou_loss(gt_centers, gt_radii, pd_centers, pd_radii):
    """All-pairs ``mean(1 - giou, 24) / 2`` in [0, 1]: ``gt_* [..., G, 2|24]``
    and ``pd_* [..., P, 2|24]`` -> ``[..., G, P]``."""
    diff = gt_centers[..., :, None, :] - pd_centers[..., None, :, :]
    dist = torch.sqrt((diff ** 2).sum(dim=-1))[..., None]
    giou = circle_giou_24(dist, gt_radii[..., :, None, :],
                          pd_radii[..., None, :, :])
    return (1.0 - giou).mean(dim=-1) * 0.5


def pairwise_circle_similarity(gt_centers, gt_radii, pd_centers, pd_radii,
                               reference_parity: bool = False):
    """SimOTA pairing statistic ``[..., G, P]``: ``1 - loss`` (higher is
    better, as SimOTA's ``-log`` cost and dynamic k expect), or with
    ``reference_parity`` the reference's raw loss value."""
    loss = pairwise_circle_giou_loss(gt_centers, gt_radii, pd_centers,
                                     pd_radii)
    return loss if reference_parity else 1.0 - loss
