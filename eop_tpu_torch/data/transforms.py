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
* :func:`resize_linear` is ``cv2.resize(INTER_LINEAR)`` bit for bit (its
  fixed-point arithmetic, in numpy), and :func:`resized_at` the same
  pixels picked out one by one; the feature-map study, held to OpenCV's
  pixels, resizes through them.  Taking 1.5-2.2 times as long, it does not
  replace :func:`resize_host` on the loader's and the letterbox's path.
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


_COEF = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE: 11 fractional bits


def _linear_taps(n_src: int, n_dst: int, clamp: bool):
    """Source indices (clamped) and 11-bit weights of OpenCV's bilinear
    resize along one axis: ``f = fp32((d + 0.5) * (1 / (n_dst / n_src)) -
    0.5)``, weights ``round(1 - frac)``, ``round(frac)``.  Along x
    (``clamp``) a tap before the first or past the last pixel takes the edge
    pixel with weight 1; along y the weights stay and the rows clamp."""
    d = np.arange(n_dst)
    f = ((d + 0.5) * (1.0 / (n_dst / n_src)) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= n_src - 1)
        f[edge] = 0
        s = np.where(s < 0, 0, np.where(s >= n_src - 1, n_src - 1, s))
    w1 = np.rint(f * _COEF).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * _COEF).astype(np.int32)
    return np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), w0, w1


def _along_x(p0, p1, a0, a1):
    """OpenCV's horizontal pass: uint8 taps times 11-bit weights, shifted
    by 4 (int32)."""
    r = p0 * a0
    r += p1 * a1
    r >>= 4
    return r


def _along_y(r0, r1, b0, b1):
    """OpenCV's vertical pass over two horizontal sums: each times its
    weight's high half (``>> 16``), then rounded by 2 bits to uint8."""
    out = r0 * b0
    out >>= 16
    r1 = r1 * b1
    r1 >>= 16
    out += r1 + 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_linear(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """uint8 ``[H, W, C]`` -> uint8 ``[*hw, C]``, bit for bit
    ``cv2.resize(img, (w, h))`` (INTER_LINEAR's fixed-point path), in
    numpy.  The feature-map study's warps and letterbox use it, whose
    pixels are held to OpenCV's; it takes 1.5-2.2 times :func:`resize_host`'s
    time (``chip_smoke.py``'s ``host_resize``), which the loader and the
    serving letterbox keep."""
    h, w = img.shape[:2]
    if (h, w) == tuple(hw):
        return np.ascontiguousarray(img)
    c = int(np.prod(img.shape[2:], dtype=np.int64))
    sx, sx1, a0, a1 = _linear_taps(w, hw[1], True)
    sy, sy1, b0, b1 = _linear_taps(h, hw[0], False)
    # the channels flattened into the columns: contiguous rows
    ch = np.arange(c)
    x = np.ascontiguousarray(img).reshape(h, w * c)
    rows = _along_x(x[:, (sx[:, None] * c + ch).ravel()],
                    x[:, (sx1[:, None] * c + ch).ravel()],
                    np.repeat(a0, c), np.repeat(a1, c))
    out = _along_y(rows[sy], rows[sy1], b0[:, None], b1[:, None])
    return out.reshape(tuple(hw) + img.shape[2:])


def resized_at(img: np.ndarray, hw: Tuple[int, int], ys: np.ndarray,
               xs: np.ndarray) -> np.ndarray:
    """``resize_linear(img, hw)[ys, xs]`` (``[*ys.shape, C]``), computing
    only those pixels."""
    h, w = img.shape[:2]
    if (h, w) == tuple(hw):
        return img[ys, xs]
    sx, sx1, a0, a1 = (t[xs] for t in _linear_taps(w, hw[1], True))
    sy, sy1, b0, b1 = (t[ys] for t in _linear_taps(h, hw[0], False))
    extra = (Ellipsis,) + (None,) * (img.ndim - 2)
    a0, a1, b0, b1 = (v[extra] for v in (a0, a1, b0, b1))
    return _along_y(_along_x(img[sy, sx], img[sy, sx1], a0, a1),
                    _along_x(img[sy1, sx], img[sy1, sx1], a0, a1), b0, b1)


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
