"""24-point star-convex polygon decode (counterpart of
``eop_tpu/ops/polygon.py``).

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
    """(centers [..., 2], radii [..., 24]) -> xy points [..., 24, 2]."""
    if reference_parity:
        cos_t, sin_t = COS_ANGLES_PARITY, SIN_ANGLES_PARITY
    else:
        cos_t, sin_t = COS_ANGLES, SIN_ANGLES
    cos_t = torch.as_tensor(cos_t, device=radii.device, dtype=radii.dtype)
    sin_t = torch.as_tensor(sin_t, device=radii.device, dtype=radii.dtype)
    x = centers[..., 0:1] + radii * cos_t
    y = centers[..., 1:2] + radii * sin_t
    return torch.stack([x, y], dim=-1)
