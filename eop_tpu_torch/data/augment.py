"""Host-side augmentation of the data pipeline, numpy only (counterpart of
``eop_tpu/data/augment.py``): HSV jitter, random affine, horizontal mirror,
the letterbox, and the bbox family's train and val transforms, whose label
rows are ``[max_labels, 5]`` of ``[cls, cx, cy, w, h]``.

``eop_tpu`` calls OpenCV for the colour conversions, the lookup table and
the warp; the card's hosts have no OpenCV, so they are written here in
numpy, aimed at the bytes OpenCV 4.11+ gives on x86 (measured against
``cv2`` 5.0 in ``tests/test_torch_bbox_data.py``):

* BGR -> HSV (uint8, hue 0..179): OpenCV's integer formula with its
  12-bit division tables; equal for all 2**24 colours.
* HSV -> BGR (uint8): OpenCV's vector path, fp32 with fused multiply-adds
  and truncation; equal for all 2**24 triples.  OpenCV converts the last
  ``width % step`` pixels of a row (step 32 or 64 pixels with AVX2 or
  AVX-512) with its scalar code, which rounds instead: there the two may
  differ by one level.  Every image this pipeline converts is 640 (or a
  multiple of 64) pixels wide.
* ``warpAffine`` (bilinear, constant border 114): OpenCV inverts the matrix
  in float64 and maps each output pixel in fp32 (the column term by a fused
  multiply-add), interpolates in fp32 with fused multiply-adds and rounds to
  nearest even; equal to ``cv2.warpAffine`` where the output width is a
  multiple of 16 (its vector step), as the mosaic's is.

Randomness flows through an explicit ``np.random.Generator`` in
``eop_tpu``'s order of draws, so a seeded pipeline draws what ``eop_tpu``'s
draws.  The letterbox resizes through :func:`resize_host` (one level of
``cv2.resize``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from .transforms import PAD_VALUE, resize_host

_PAD = int(PAD_VALUE)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def xyxy2cxcywh_np(bboxes: np.ndarray) -> np.ndarray:
    """Corner boxes -> centre boxes, out of place (extra columns kept)."""
    out = np.empty_like(bboxes)
    out[:, 2:4] = bboxes[:, 2:4] - bboxes[:, 0:2]
    out[:, 0:2] = bboxes[:, 0:2] + 0.5 * out[:, 2:4]
    if bboxes.shape[1] > 4:
        out[:, 4:] = bboxes[:, 4:]
    return out


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12
_LEVELS = np.arange(256, dtype=np.float64)
with np.errstate(divide="ignore"):
    # OpenCV's sdiv_table and hdiv_table180 (saturate_cast rounds to even)
    _SDIV = np.where(_LEVELS > 0, np.rint((255 << _HSV_SHIFT) / _LEVELS),
                     0).astype(np.int64)
    _HDIV = np.where(_LEVELS > 0,
                     np.rint((180 << _HSV_SHIFT) / (6.0 * _LEVELS)),
                     0).astype(np.int64)
# the source of B, G, R in each hue sector: v, v(1-s), v(1-sf), v(1-s(1-f))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """uint8 BGR ``[..., 3]`` -> uint8 HSV, hue in 0..179
    (``cv2.COLOR_BGR2HSV``)."""
    x = img.astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _fused(a, b, c) -> np.ndarray:
    """fp32 ``a * b + c`` rounded once, as a fused multiply-add: the fp32
    product is exact in float64."""
    return (np.float64(1.0) * a * b + c).astype(np.float32)


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """uint8 HSV ``[..., 3]`` (hue 0..179) -> uint8 BGR
    (``cv2.COLOR_HSV2BGR``'s vector path)."""
    f32 = np.float32
    inv255 = f32(1.0 / 255.0)
    h = img[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = img[..., 1].astype(f32) * inv255
    v = img[..., 2].astype(f32) * inv255
    pre = np.trunc(h)
    frac = h - pre
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * _fused(-s, frac, one),
                    v * _fused(-s, one - frac, one)], axis=-1)
    sector = (pre - np.trunc(pre * f32(1.0 / 6.0)) * f32(6.0)).astype(np.int64)
    out = np.take_along_axis(tab, _SECTORS[sector], axis=-1) * f32(255.0)
    return np.clip(np.trunc(out), 0, 255).astype(np.uint8)


def augment_hsv(img: np.ndarray, rng: np.random.Generator, hgain=5,
                sgain=30, vgain=30) -> None:
    """In-place additive HSV jitter of a uint8 BGR image: each channel gets
    a uniform offset in +-gain with probability 1/2 (hue wraps mod 180,
    saturation and value saturate), through lookup tables on the HSV planes.
    Where all three offsets truncate to 0 the image is left as it is."""
    deltas = (rng.uniform(-1.0, 1.0, 3) * (hgain, sgain, vgain)
              * rng.integers(0, 2, 3)).astype(np.int16)
    if not deltas.any():
        return
    ramp = np.arange(256, dtype=np.int16)
    tables = np.stack([
        ((ramp + deltas[0]) % 180).astype(np.uint8),
        np.clip(ramp + deltas[1], 0, 255).astype(np.uint8),
        np.clip(ramp + deltas[2], 0, 255).astype(np.uint8),
    ])
    hsv = bgr_to_hsv(img)
    jittered = np.stack([tables[c][hsv[..., c]] for c in range(3)], axis=-1)
    img[...] = hsv_to_bgr(jittered)


# ---------------------------------------------------------------------------
# geometric
# ---------------------------------------------------------------------------

def get_aug_params(value, rng: np.random.Generator, center=0.0):
    """Uniform draw in ``center +- value`` (scalar) or ``[lo, hi]`` (pair)."""
    if isinstance(value, (int, float)):
        lo, hi = center - value, center + value
    elif len(value) == 2:
        lo, hi = value
    else:
        raise ValueError("Affine params should be either a sequence of two "
                         f"values or a single float. Got {value}")
    return rng.uniform(lo, hi)


def _rot_scale_mat(angle_deg: float, scale: float) -> np.ndarray:
    c = scale * math.cos(math.radians(angle_deg))
    s = scale * math.sin(math.radians(angle_deg))
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])


def _shear_mat(shear_x_deg: float, shear_y_deg: float) -> np.ndarray:
    return np.array([
        [1.0, math.tan(math.radians(shear_y_deg)), 0.0],
        [math.tan(math.radians(shear_x_deg)), 1.0, 0.0],
        [0.0, 0.0, 1.0],
    ])


def get_affine_matrix(target_size, rng, degrees=10, translate=0.1,
                      scales=0.1, shear=10):
    """A 2x3 affine: shear after rotation-scale, then a translation by a
    fraction of the target extent ``(w, h)``.  Returns (M, scale)."""
    angle = get_aug_params(degrees, rng)
    scale = get_aug_params(scales, rng, center=1.0)
    if scale <= 0.0:
        raise ValueError("Argument scale should be positive")
    warp = _shear_mat(get_aug_params(shear, rng),
                      get_aug_params(shear, rng)) @ _rot_scale_mat(angle, scale)
    warp[0, 2] = get_aug_params(translate, rng) * target_size[0]
    warp[1, 2] = get_aug_params(translate, rng) * target_size[1]
    return warp[:2], scale


def apply_affine_to_bboxes(targets, target_size, M):
    """Warp the 4 corners of each xyxy box, take their hull, clip to the
    target ``(w, h)``; in place."""
    quad = targets[:, [[0, 1], [2, 3], [0, 3], [2, 1]]]  # [N, 4, 2]
    warped = quad @ M[:, :2].T + M[:, 2]
    hull = np.concatenate([warped.min(axis=1), warped.max(axis=1)], axis=1)
    limit = np.asarray(target_size, dtype=hull.dtype)
    targets[:, :4] = np.clip(hull, 0.0, np.tile(limit, 2))
    return targets


def _inverse_affine(M: np.ndarray) -> np.ndarray:
    """OpenCV's inverse of a 2x3 affine, in float64, flat [6]."""
    m = M.astype(np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(img: np.ndarray, M: np.ndarray, dsize,
                border: int = _PAD) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, borderValue=(border,) * 3)`` for a
    uint8 ``[H, W, 3]`` image: bilinear, constant border; ``dsize`` is
    ``(w, h)``."""
    f32 = np.float32
    w_out, h_out = dsize
    m = _inverse_affine(M).astype(f32)
    xs = np.arange(w_out, dtype=f32)[None, :]
    ys = np.arange(h_out, dtype=f32)[:, None]
    sx = _fused(m[0], xs, m[1] * ys + m[2])
    sy = _fused(m[3], xs, m[4] * ys + m[5])
    return remap(img, sx, sy, border)


def _bilinear(ax, ay, v00, v01, v10, v11) -> np.ndarray:
    """OpenCV 4.11+ / 5.0's bilinear blend: fp32 FMAs along x, then y,
    rounded to even and saturated to uint8."""
    top = _fused(ax, v01 - v00, v00)
    bottom = _fused(ax, v11 - v10, v10)
    out = _fused(ay, bottom - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          border: int = _PAD, nearest: bool = False) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR or INTER_NEAREST,
    borderMode=BORDER_CONSTANT, borderValue=(border,) * C)`` for a uint8
    ``[H, W, C]`` image and fp32 maps (OpenCV 4.11+ / 5.0's vector paths:
    bilinear with fp32 FMAs, rounded to even; nearest by rounding the
    coordinate)."""
    return remap_sampled(lambda y, x: img[y, x], img.shape[:2],
                         img.shape[2:], map_x, map_y, border, nearest)


def remap_sampled(sample, hw, channels, map_x: np.ndarray,
                  map_y: np.ndarray, border: int, nearest: bool = False):
    """:func:`remap` of an image given by ``sample(ys, xs)`` (its uint8
    pixels ``[N, *channels]`` at integer coordinates inside ``hw``), which
    is asked only for the pixels the map reads: an image too large to
    build whole, e.g. one upscaled to the 13,200 columns of the sector
    warp.  A tap outside the image reads ``sample`` at the nearest edge
    and is then set to ``border``."""
    h, w = hw
    if nearest:
        xs = [np.rint(map_x).astype(np.int64)]
        ys = [np.rint(map_y).astype(np.int64)]
    else:
        fx, fy = np.floor(map_x), np.floor(map_y)
        x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
        xs, ys = [x0, x0 + 1], [y0, y0 + 1]
    # per axis and tap: the clamped coordinate, and where it left the image
    cx = [(np.clip(x, 0, w - 1), (x < 0) | (x >= w)) for x in xs]
    cy = [(np.clip(y, 0, h - 1), (y < 0) | (y >= h)) for y in ys]

    def at(j, i):
        (yy, out_y), (xx, out_x) = cy[j], cx[i]
        v = sample(yy, xx)
        v[out_y | out_x] = border
        return v

    if nearest:
        return at(0, 0)
    ax, ay = (map_x - fx)[..., None], (map_y - fy)[..., None]
    return _bilinear(ax, ay, *(at(j, i).astype(np.float32)
                               for j, i in ((0, 0), (0, 1), (1, 0),
                                            (1, 1))))


def random_affine(img, targets=(), target_size=(640, 640), degrees=10,
                  translate=0.1, scales=0.1, shear=10,
                  rng: Optional[np.random.Generator] = None):
    """Warp ``img`` (uint8 BGR) and its xyxy ``targets`` by a random affine
    to ``target_size`` ``(w, h)``."""
    rng = rng or np.random.default_rng()
    M, _ = get_affine_matrix(target_size, rng, degrees, translate, scales,
                             shear)
    img = warp_affine(img, M, target_size)
    if len(targets) > 0:
        targets = apply_affine_to_bboxes(targets, target_size, M)
    return img, targets


def mirror(image, boxes, prob, rng: np.random.Generator):
    """Horizontal flip of image and xyxy boxes with probability ``prob``."""
    if rng.random() < prob:
        width = image.shape[1]
        image = image[:, ::-1]
        flipped = boxes.copy()
        flipped[:, 0] = width - boxes[:, 2]
        flipped[:, 2] = width - boxes[:, 0]
        boxes = flipped
    return image, boxes


def preproc(img: np.ndarray, input_size) -> Tuple[np.ndarray, float]:
    """Letterbox a uint8 ``[H, W, 3]`` image: scale by ``r = min(H'/H,
    W'/W)`` to ``(int(H r), int(W r))``, paste top-left on a canvas of 114,
    float32 ``[H', W', 3]``.  ``r`` and the sizes are ``eop_tpu``'s; the
    resize is :func:`resize_host` (cv2's to one level, exact at r = 1)."""
    r = min(input_size[0] / img.shape[0], input_size[1] / img.shape[1])
    if r == 1.0 and img.shape[:2] == tuple(input_size[:2]):
        return np.ascontiguousarray(img, dtype=np.float32), r
    canvas = np.full((*input_size[:2], 3), _PAD, dtype=np.uint8)
    scaled = resize_host(img, (int(img.shape[0] * r), int(img.shape[1] * r)))
    canvas[: scaled.shape[0], : scaled.shape[1]] = scaled
    return canvas.astype(np.float32), r


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _pad_rows(rows: np.ndarray, capacity: int, width: int) -> np.ndarray:
    out = np.zeros((capacity, width), dtype=np.float32)
    n = min(len(rows), capacity)
    out[:n] = rows[:n]
    return out


class TrainTransform:
    """HSV jitter, mirror and letterbox; label rows ``[max_labels, 5]`` of
    ``[cls, cx, cy, w, h]`` in letterboxed pixels.  Boxes whose shorter side
    is 1 px or less after scaling are dropped; where that drops all, the
    unaugmented image and its labels are returned instead."""

    def __init__(self, max_labels=50, flip_prob=0.5, hsv_prob=1.0,
                 seed: Optional[int] = None):
        self.max_labels = max_labels
        self.flip_prob = flip_prob
        self.hsv_prob = hsv_prob
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, image, targets, input_dim):
        if len(targets) == 0:
            image, _ = preproc(image, input_dim)
            return image, np.zeros((self.max_labels, 5), dtype=np.float32)

        original = (image.copy(), xyxy2cxcywh_np(targets[:, :4]),
                    targets[:, 4].copy())
        if self.rng.random() < self.hsv_prob:
            augment_hsv(image, self.rng)
        image, boxes = mirror(image, targets[:, :4].copy(), self.flip_prob,
                              self.rng)
        image, ratio = preproc(image, input_dim)
        boxes = xyxy2cxcywh_np(boxes) * ratio
        classes = targets[:, 4]

        healthy = boxes[:, 2:4].min(axis=1) > 1
        boxes, classes = boxes[healthy], classes[healthy]
        if len(boxes) == 0:
            image, ratio = preproc(original[0], input_dim)
            boxes, classes = original[1] * ratio, original[2]

        rows = np.concatenate([classes[:, None], boxes], axis=1)
        return image, _pad_rows(rows, self.max_labels, 5)


class ValTransform:
    """Letterbox only (NHWC float32, BGR, 0..255); ``legacy`` flips BGR ->
    RGB, scales to 0..1 and applies the ImageNet normalisation, as
    ``eop_tpu``'s legacy mode does."""

    def __init__(self, legacy: bool = False):
        self.legacy = legacy

    def __call__(self, img, res, input_size):
        img, _ = preproc(img, input_size)
        if self.legacy:
            img = img[:, :, ::-1] / 255.0
            img = (img - _IMAGENET_MEAN) / _IMAGENET_STD
            img = np.ascontiguousarray(img, dtype=np.float32)
        return img, np.zeros((1, 5), dtype=np.float32)
