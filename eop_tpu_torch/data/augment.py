"""The letterbox of the data pipeline (counterpart of ``preproc`` in
``eop_tpu/data/augment.py``).  The bbox family's augmentations (HSV,
affine, mirror) come with queue 3."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .transforms import PAD_VALUE, resize_host


def preproc(img: np.ndarray, input_size) -> Tuple[np.ndarray, float]:
    """Letterbox a uint8 ``[H, W, 3]`` image: scale by ``r = min(H'/H,
    W'/W)`` to ``(int(H r), int(W r))``, paste top-left on a canvas of 114,
    float32 ``[H', W', 3]``.  ``r`` and the sizes are ``eop_tpu``'s; the
    resize is :func:`resize_host` (cv2's to one level, exact at r = 1)."""
    r = min(input_size[0] / img.shape[0], input_size[1] / img.shape[1])
    if r == 1.0 and img.shape[:2] == tuple(input_size[:2]):
        return np.ascontiguousarray(img, dtype=np.float32), r
    canvas = np.full((*input_size[:2], 3), int(PAD_VALUE), dtype=np.uint8)
    scaled = resize_host(img, (int(img.shape[0] * r), int(img.shape[1] * r)))
    canvas[: scaled.shape[0], : scaled.shape[1]] = scaled
    return canvas.astype(np.float32), r
