"""Box and polygon drawing (counterpart of ``eop_tpu/utils/visualize.py``:
``vis`` and ``vis_24p``).

Boxes, lines and circles are drawn with numpy, pixel for pixel what
``cv2.rectangle(img, p0, p1, color, 2)``, ``cv2.polylines`` (closed,
thickness 2 or more, 8-connected) and ``cv2.circle`` (thickness 1 or
filled, 8-connected) draw: a thick line is OpenCV's quadrilateral in
16.16 fixed point, filled as its convex polygon, with a filled circle at
its end.  Labels come from ``cv2.getTextSize`` and ``cv2.putText`` (the Hershey
font), so they are drawn only where cv2 imports (inside the function, as
``data/image_io.py`` does for the formats its own decoder lacks); without
it the shapes are drawn alone, and one log line says so.  The class
colours are ``eop_tpu``'s table (its golden-ratio hue walk).
"""

from __future__ import annotations

import colorsys
import functools
import math

import numpy as np

from ..data.coco_api import clip_line
from .logger import logger


def _make_palette(n: int = 80) -> np.ndarray:
    """n visually distinct RGB colours in [0, 1] (golden-ratio hue walk)."""
    colors = []
    h = 0.0
    for i in range(n):
        h = (h + 0.61803398875) % 1.0
        s = 0.65 + 0.35 * ((i * 7) % 3) / 2.0
        v = 0.75 + 0.25 * ((i * 5) % 2)
        colors.append(colorsys.hsv_to_rgb(h, s, v))
    return np.asarray(colors, dtype=np.float32)


_COLORS = _make_palette(80)
_warned = []


def _fill(img: np.ndarray, y0: int, y1: int, x0: int, x1: int,
          color) -> None:
    """Pixels ``[y0, y1] x [x0, x1]`` (inclusive), clipped, set to
    ``color``."""
    h, w = img.shape[:2]
    y0, x0 = max(y0, 0), max(x0, 0)
    y1, x1 = min(y1, h - 1), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def rectangle(img: np.ndarray, p0, p1, color) -> np.ndarray:
    """``cv2.rectangle(img, p0, p1, color, 2)``: each side a band of three
    pixels centred on it, the horizontal ones between the corners' x, the
    vertical ones between their y."""
    (xa, ya), (xb, yb) = p0, p1
    x0, x1 = sorted((int(xa), int(xb)))
    y0, y1 = sorted((int(ya), int(yb)))
    for y in (y0, y1):
        _fill(img, y - 1, y + 1, x0, x1, color)
    for x in (x0, x1):
        _fill(img, y0, y1, x - 1, x + 1, color)
    return img


def _cv2_or_none(what: str):
    """``cv2`` where it imports, else None (one log line a process)."""
    try:
        import cv2
    except ImportError:
        if not _warned:
            _warned.append(True)
            logger.info(f"{what}: OpenCV is not installed; drawing the "
                        "shapes without their labels")
        return None
    return cv2


_SHIFT = 16
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


@functools.lru_cache(maxsize=64)
def _circle_offsets(radius: int, fill: bool):
    """The pixels of OpenCV's ``Circle`` about (0, 0) as (dys, dxs): its
    integer midpoint walk, rows of spans where ``fill``, else the
    eight-fold points."""
    ys, xs = [], []
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, xa, xb in ((-dy, -dx, dx), (dy, -dx, dx), (-dx, -dy, dy),
                          (dx, -dy, dy)):
            span = range(xa, xb + 1) if fill else (xa, xb)
            ys += [y] * len(span)
            xs += span
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return tuple(ys), tuple(xs)


class _Pixels:
    """Pixels gathered for one colour, points and row spans as Python
    ints, painted at once (clipped to the image) by :meth:`paint`."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w
        self.ys, self.xs = [], []
        self.rows, self.x1, self.x2 = [], [], []

    def circle(self, cx: int, cy: int, radius: int, fill: bool) -> None:
        dys, dxs = _circle_offsets(radius, fill)
        self.ys += [cy + d for d in dys]
        self.xs += [cx + d for d in dxs]

    def paint(self, img: np.ndarray, color) -> np.ndarray:
        ys, xs = np.asarray(self.ys, np.int64), np.asarray(self.xs, np.int64)
        if self.rows:
            rows, x1 = np.asarray(self.rows), np.asarray(self.x1)
            n = np.asarray(self.x2) - x1 + 1
            keep = n > 0
            rows, x1, n = rows[keep], x1[keep], n[keep]
            starts = np.repeat(np.cumsum(n) - n - x1, n)
            ys = np.concatenate([ys, np.repeat(rows, n)])
            xs = np.concatenate([xs, np.arange(int(n.sum())) - starts])
        keep = (ys >= 0) & (ys < self.h) & (xs >= 0) & (xs < self.w)
        img[ys[keep], xs[keep]] = color
        return img


def circle(img: np.ndarray, center, radius: int, color,
           thickness: int = 1) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, thickness)`` for thickness
    1 or -1 (filled), 8-connected, in place."""
    if thickness not in (1, -1):
        raise ValueError(f"thickness {thickness}: 1 or -1 (filled)")
    if radius < 0:
        raise ValueError(f"radius {radius} < 0")
    pix = _Pixels(*img.shape[:2])
    pix.circle(int(center[0]), int(center[1]), int(radius), thickness < 0)
    return pix.paint(img, color)


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _line_fixed(pix: _Pixels, p1, p2) -> None:
    """OpenCV's ``Line2``, the outline of a filled polygon with 16.16
    vertices: clipped in 16.16, then one pixel a step along the major
    axis from the rounded start, the minor axis stepped by the slope in
    16.16, and the rounded end."""
    inside, (x1, y1), (x2, y2) = clip_line(
        pix.w << _SHIFT, pix.h << _SHIFT, p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    major_x = abs(dx) > abs(dy)
    if (dx if major_x else dy) < 0:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        dx, dy = -dx, -dy
    if major_x:
        step = _tdiv(dy * _ONE, abs(dx) | 1)
        count = (x2 - x1) >> _SHIFT
    else:
        step = _tdiv(dx * _ONE, abs(dy) | 1)
        count = (y2 - y1) >> _SHIFT
    pix.ys.append((y2 + _HALF) >> _SHIFT)
    pix.xs.append((x2 + _HALF) >> _SHIFT)
    if major_x:
        x, y = (x1 + _HALF) >> _SHIFT, y1 + _HALF
        pix.ys += [(y + i * step) >> _SHIFT for i in range(count + 1)]
        pix.xs += range(x, x + count + 1)
    else:
        x, y = x1 + _HALF, (y1 + _HALF) >> _SHIFT
        pix.ys += range(y, y + count + 1)
        pix.xs += [(x + i * step) >> _SHIFT for i in range(count + 1)]


def _fill_convex_fixed(pix: _Pixels, v) -> None:
    """OpenCV's ``FillConvexPoly`` for 16.16 vertices ``v`` (8-connected):
    the outline by :func:`_line_fixed`, then each row from the left edge
    to the right, the edges walked from the top vertex both ways with
    rounded 16.16 slopes."""
    h, w = pix.h, pix.w
    n = len(v)
    for i in range(n):
        _line_fixed(pix, v[i - 1], v[i])
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin = (min(p[0] for p in v) + _HALF) >> _SHIFT
    xmax = (max(p[0] for p in v) + _HALF) >> _SHIFT
    ymin = (min(ys) + _HALF) >> _SHIFT
    ymax = (max(ys) + _HALF) >> _SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [vertex index, step, x, dx, y where it ends]
    edges = [[imin, 1, -_ONE, 0, ymin], [imin, n - 1, -_ONE, 0, ymin]]
    left = n  # edges not yet walked, shared by both sides
    y = ymin
    while y <= ymax:
        for e in edges:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % n
            while True:
                left -= 1
                if left < 0:
                    break
                ty = (v[idx][1] + _HALF) >> _SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[:] = [idx, di, xs,
                            _tdiv((xe - xs) * 2 + ty - y, 2 * (ty - y)), ty]
                    break
                idx0, idx = idx, (idx + di) % n
        if left < 0:
            break
        # rows [y, stop) keep both edges
        stop = min(edges[0][4], edges[1][4], ymax + 1)
        (_, _, xa, da, _), (_, _, xb, db, _) = edges
        for r in range(max(y, 0), stop):
            a, b = xa + (r - y) * da, xb + (r - y) * db
            if a > b:
                a, b = b, a
            pix.rows.append(r)
            pix.x1.append(max((a + _HALF) >> _SHIFT, 0))
            pix.x2.append(min((b + _HALF) >> _SHIFT, w - 1))
        for e in edges:
            e[2] += (stop - y) * e[3]
        y = stop


def _thick_line(pix: _Pixels, p0, p1, thickness: int) -> None:
    """OpenCV's ``ThickLine`` between integer points for ``thickness`` > 1
    (8-connected; the round cap at the end only, as a closed ``polylines``
    asks):
    the segment clipped to the image grown by ``thickness`` on each side
    (OpenCV 5 clips first: a line past the image moves by the clip's
    truncation), then the quadrilateral of half-width ``thickness / 2`` in
    16.16, filled, and a filled circle of radius ``thickness / 2`` rounded
    at the end."""
    t = thickness
    inside, (x0, y0), (x1, y1) = clip_line(
        pix.w + 2 * t, pix.h + 2 * t, (p0[0] + t, p0[1] + t),
        (p1[0] + t, p1[1] + t))
    if not inside:
        return
    x0, y0, x1, y1 = x0 - t, y0 - t, x1 - t, y1 - t
    dx, dy = float(x0 - x1), float(y1 - y0)
    r = dx * dx + dy * dy
    half = t << (_SHIFT - 1)
    if r > 2.220446049250313e-16:
        r = (half + (t & 1) * _ONE * 0.5) / math.sqrt(r)
        px, py = round(dy * r), round(dx * r)
        fx0, fy0, fx1, fy1 = (x0 << _SHIFT, y0 << _SHIFT, x1 << _SHIFT,
                              y1 << _SHIFT)
        _fill_convex_fixed(pix, [(fx0 + px, fy0 + py), (fx0 - px, fy0 - py),
                                 (fx1 - px, fy1 - py), (fx1 + px, fy1 + py)])
    pix.circle(x1, y1, (half + _HALF) >> _SHIFT, True)


def polylines(img: np.ndarray, pts, color, thickness: int = 2) -> np.ndarray:
    """``cv2.polylines(img, [pts], True, color, thickness)`` for integer
    points and ``thickness`` 2 or more (8-connected, shift 0), in place:
    each edge OpenCV's ``ThickLine``."""
    if thickness < 2:
        raise ValueError(f"thickness {thickness}: 2 or more")
    p = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    pix = _Pixels(*img.shape[:2])
    for i in range(len(p)):
        _thick_line(pix, p[i - 1], p[i], thickness)
    return pix.paint(img, color)


def vis(img, boxes, scores, cls_ids, conf=0.5, class_names=None):
    """Draw the xyxy ``boxes`` scoring at least ``conf`` on ``img`` (BGR
    uint8, in place), each with a ``name:score%`` label where cv2 is
    installed."""
    cv2 = _cv2_or_none("vis")
    for i in range(len(boxes)):
        box = boxes[i]
        cls_id = int(cls_ids[i])
        score = scores[i]
        if score < conf:
            continue
        x0, y0, x1, y1 = (int(v) for v in box[:4])
        rgb = _COLORS[cls_id % len(_COLORS)]
        color = (rgb * 255).astype(np.uint8).tolist()
        rectangle(img, (x0, y0), (x1, y1), color)
        if cv2 is None:
            continue
        name = class_names[cls_id] if class_names is not None else str(
            cls_id)
        text = f"{name}:{score * 100:.1f}%"
        txt_color = (0, 0, 0) if np.mean(rgb) > 0.5 else (255, 255, 255)
        font = cv2.FONT_HERSHEY_SIMPLEX
        txt_size = cv2.getTextSize(text, font, 0.4, 1)[0]
        bar = (rgb * 255 * 0.7).astype(np.uint8).tolist()
        _fill(img, y0 + 1, y0 + int(1.5 * txt_size[1]), x0,
              x0 + txt_size[0] + 1, bar)
        cv2.putText(img, text, (x0, y0 + txt_size[1]), font, 0.4, txt_color,
                    thickness=1)
    return img


def vis_24p(img, detections, ratio=1.0, conf=0.5, class_names=None,
            draw_center=True):
    """Draw 24-point polygons from detection rows ``[x, y, r1..r24, obj,
    cls_conf, cls]`` scoring at least ``conf`` on ``img`` (BGR uint8, in
    place): the closed polygon at thickness 2, a filled circle of radius 3
    at its centre, and a ``name:score%`` label where cv2 is installed.
    ``ratio`` is the letterbox scale to undo (coordinates divided by it).
    """
    from ..ops.polygon import COS_ANGLES, SIN_ANGLES

    cv2 = _cv2_or_none("vis_24p")
    for det in detections:
        score = float(det[26] * det[27])
        if score < conf:
            continue
        cls_id = int(det[28])
        cx, cy = det[0] / ratio, det[1] / ratio
        radii = np.asarray(det[2:26]) / ratio
        xs = (cx + radii * COS_ANGLES).astype(np.int32)
        ys = (cy + radii * SIN_ANGLES).astype(np.int32)
        color = (_COLORS[cls_id % len(_COLORS)] * 255).astype(
            np.uint8).tolist()
        polylines(img, np.stack([xs, ys], axis=1), color, thickness=2)
        if draw_center:
            circle(img, (int(cx), int(cy)), 3, color, -1)
        if cv2 is None:
            continue
        name = class_names[cls_id] if class_names is not None else str(
            cls_id)
        cv2.putText(img, f"{name}:{score * 100:.1f}%",
                    (int(cx), max(int(cy) - 5, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
    return img
