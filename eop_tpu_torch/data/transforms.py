"""Letterbox resize, on the device and on the host (counterpart of
``eop_tpu/data/transforms.py``).

Scale by ``r = min(H'/h, W'/w)`` (bilinear), paste top-left on a canvas of
114, no normalization.

* :func:`letterbox_batch_device` follows ``jax.image.resize(...,
  "bilinear")``, which antialiases when it shrinks an image; torch matches
  it with ``antialias=True`` (without it the two differ by tens of levels).
* :func:`resize_host` replaces ``cv2.resize(INTER_LINEAR)`` for uint8
  images on every machine, OpenCV installed or not: torch bilinear without
  antialiasing and with rounding, which agrees with cv2 to one level.  The
  host letterbox, the data pipeline's ``preproc`` and ``fit_resize`` all
  resize through it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

PAD_VALUE = 114.0


def _resize_nhwc(imgs: torch.Tensor, hw: Tuple[int, int],
                 antialias: bool) -> torch.Tensor:
    """Bilinear resize of ``[B, H, W, C]`` float (half-pixel centers)."""
    if tuple(imgs.shape[1:3]) == tuple(hw):
        return imgs
    out = F.interpolate(imgs.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                        align_corners=False, antialias=antialias)
    return out.permute(0, 2, 3, 1)


def letterbox_batch_device(imgs: torch.Tensor, src_hw: Tuple[int, int],
                           input_size: Tuple[int, int]):
    """Letterbox a batch of same-shape images ``[B, H, W, 3]`` float on their
    device.  Returns (``[B, H', W', 3]``, ratio)."""
    h, w = src_hw
    in_h, in_w = input_size
    r = min(in_h / h, in_w / w)
    nh, nw = int(h * r), int(w * r)
    resized = _resize_nhwc(imgs, (nh, nw), antialias=True)
    padded = torch.full((imgs.shape[0], in_h, in_w, 3), PAD_VALUE,
                        dtype=imgs.dtype, device=imgs.device)
    padded[:, :nh, :nw, :] = resized
    return padded, r


def resize_host(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """uint8 ``[H, W, C]`` -> uint8 ``[*hw, C]`` on the host, bilinear with
    half-pixel centers and no antialiasing, rounded to the nearest level
    (an unchanged size returns the pixels as they are)."""
    x = torch.from_numpy(np.ascontiguousarray(img)).float()[None]
    out = _resize_nhwc(x, tuple(hw), antialias=False)[0]
    return out.round().clamp(0, 255).to(torch.uint8).numpy()


def letterbox_host(img: np.ndarray, src_hw: Tuple[int, int]):
    """uint8 HWC image -> (uint8 ``[*src_hw, 3]`` canvas, ratio), on the
    host, without OpenCV."""
    h, w = img.shape[:2]
    if (h, w) == tuple(src_hw):
        return np.ascontiguousarray(img), 1.0
    r = min(src_hw[0] / h, src_hw[1] / w)
    nh, nw = int(h * r), int(w * r)
    canvas = np.full((src_hw[0], src_hw[1], 3), int(PAD_VALUE), np.uint8)
    canvas[:nh, :nw] = resize_host(img, (nh, nw))
    return canvas, r
