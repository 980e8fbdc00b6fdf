"""The fit-resize of the file datasets (counterpart of ``fit_resize`` in
``eop_tpu/data/cached_dataset.py``; the COCO / VOC base with its image
cache comes with queue 3)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .transforms import resize_host


def fit_resize(img: np.ndarray, img_size) -> Tuple[np.ndarray, float]:
    """Shrink or grow ``img`` by the largest ratio that fits ``img_size``."""
    r = min(img_size[0] / img.shape[0], img_size[1] / img.shape[1])
    return resize_host(img, (int(img.shape[0] * r), int(img.shape[1] * r))), r
