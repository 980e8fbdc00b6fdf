"""24-point star-convex polygon geometry (counterpart of
``eop_tpu/ops/polygon.py``): decode radii to points, label rows to radii,
and the angle-sum point-in-polygon test the 24p SimOTA picks candidate
anchors with.

Rays start at the +x axis in 15 degree steps.  The reference's NMS path
scales each direction by its angle (theta * cos(theta), collapsing ray 0);
``reference_parity=True`` reproduces that, the default uses cos(theta).
"""

from __future__ import annotations

import numpy as np
import torch

N_POINTS = 24
STEP_RAD = 15.0 * np.pi / 180.0
ANGLES = np.arange(N_POINTS, dtype=np.float32) * STEP_RAD
COS_ANGLES = np.cos(ANGLES).astype(np.float32)
SIN_ANGLES = np.sin(ANGLES).astype(np.float32)
COS_ANGLES_PARITY = (ANGLES * np.cos(ANGLES)).astype(np.float32)
SIN_ANGLES_PARITY = (ANGLES * np.sin(ANGLES)).astype(np.float32)


def polygon_points_from_radii(centers: torch.Tensor, radii: torch.Tensor,
                              reference_parity: bool = False) -> torch.Tensor:
    """(centers [..., 2], radii [..., 24]) -> xy points [..., 24, 2].  The
    direction tables are fp32, so bf16 inputs give fp32 points (JAX's
    promotion against the numpy tables)."""
    if reference_parity:
        cos_t, sin_t = COS_ANGLES_PARITY, SIN_ANGLES_PARITY
    else:
        cos_t, sin_t = COS_ANGLES, SIN_ANGLES
    cos_t = torch.as_tensor(cos_t, device=radii.device)
    sin_t = torch.as_tensor(sin_t, device=radii.device)
    x = centers[..., 0:1] + radii * cos_t
    y = centers[..., 1:2] + radii * sin_t
    return torch.stack([x, y], dim=-1)


def radii_from_points(labels_xy: torch.Tensor) -> torch.Tensor:
    """[..., 50] rows (cx, cy, 24 x (x, y)) -> radii [..., 24]."""
    dx = labels_xy[..., 2::2] - labels_xy[..., 0:1]
    dy = labels_xy[..., 3::2] - labels_xy[..., 1:2]
    return torch.sqrt(dx * dx + dy * dy)


def pts_in_poly(poly_x: torch.Tensor, poly_y: torch.Tensor,
                pts_x: torch.Tensor, pts_y: torch.Tensor,
                degree_threshold: float = 350.0) -> torch.Tensor:
    """Angle-sum point-in-polygon test: a point is inside when the absolute
    angles it sees between consecutive vertices sum to (almost) 360 degrees
    (the reference's threshold is 350).

    ``poly_x, poly_y`` [..., G, 24] vertices, ``pts_x, pts_y`` [..., A] query
    points (leading dimensions are a batch) -> bool [..., G, A].
    """
    px, py = pts_x[..., None, None, :], pts_y[..., None, None, :]
    vsx = poly_x[..., None] - px          # [..., G, 24, A] vertex -> point
    vsy = poly_y[..., None] - py
    vex = torch.roll(poly_x, -1, dims=-1)[..., None] - px
    vey = torch.roll(poly_y, -1, dims=-1)[..., None] - py
    cross = vsx * vey - vex * vsy
    dot = vsx * vex + vsy * vey
    ang = torch.atan2(cross.abs(), dot)   # in [0, pi]
    total_deg = ang.sum(dim=-2) * (180.0 / np.pi)
    return total_deg >= degree_threshold


def pts_in_poly_from_labels(labels_xy: torch.Tensor, pts_x: torch.Tensor,
                            pts_y: torch.Tensor,
                            degree_threshold: float = 350.0) -> torch.Tensor:
    """The same test straight from padded label rows [..., G, 50]."""
    return pts_in_poly(labels_xy[..., 2::2], labels_xy[..., 3::2], pts_x,
                       pts_y, degree_threshold)
