"""Plane geometry on integer pixels, the OpenCV calls the 24-point label
generator and the mask viewer make, in numpy (the card's machine has no
OpenCV):

* :func:`convex_hull`: ``cv2.convexHull`` of int32 points (a monotone
  chain; the hull's vertex set, collinear points dropped);
* :func:`contour_area`: ``cv2.contourArea`` (the shoelace formula in
  float64: on integer vertices exact in halves, so a gate ``<=`` / ``>=``
  on it decides as OpenCV's does);
* :func:`find_contours_external`: ``cv2.findContours(mask, RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)``, Suzuki and Abe's border following with OpenCV's
  marks, scan and compression, point for point.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _cross(o, a, b) -> int:
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])


def convex_hull(points) -> np.ndarray:
    """The convex hull of integer ``points`` (``[n, 2]`` or ``[n, 1, 2]``)
    as int32 ``[k, 1, 2]`` vertices, collinear and repeated points dropped;
    one point (or all equal) gives that point, a collinear set its two
    ends."""
    pts = sorted({(int(x), int(y))
                  for x, y in np.asarray(points).reshape(-1, 2)})
    if len(pts) <= 2:
        return np.asarray(pts, np.int32).reshape(-1, 1, 2)
    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and _cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and _cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1], np.int32).reshape(-1, 1, 2)


def contour_area(contour) -> float:
    """The unsigned area of the polygon ``contour`` (``[n, 2]`` or ``[n, 1,
    2]``), by the shoelace formula in float64; 0 for fewer than 3
    vertices."""
    p = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(p) < 3:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return float(abs((q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]).sum()) * 0.5)


# chain code s -> (dx, dy): 0 right, then counterclockwise on the screen
_STEPS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1),
          (1, 1))
_LEFT_MARK = 2           # OpenCV's nbd: a traced pixel
_RIGHT_MARK = 2 | -128   # nbd | -128: a traced pixel whose right is 0


def _follow(img: list, stride: int, i0: int, x: int, y: int) -> list:
    """Trace the outer border starting at flat index ``i0`` (pixel ``x,
    y``) as OpenCV's ``icvFetchContour`` does with CHAIN_APPROX_SIMPLE:
    marks the border in ``img``; returns the points where the chain code
    changes."""
    deltas = [dx + dy * stride for dx, dy in _STEPS] * 2
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        img[i0] = _RIGHT_MARK
        return [(x, y)]
    out = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        # the search passed direction 0 (the pixel to the right) empty
        if 0 <= s - 1 < s_end:
            img[i3] = _RIGHT_MARK
        elif img[i3] == 1:
            img[i3] = _LEFT_MARK
        if s != prev_s:
            out.append((x, y))
            prev_s = s
        x += _STEPS[s][0]
        y += _STEPS[s][1]
        if i4 == i0 and i3 == i1:
            return out
        i3 = i4
        s = (s + 4) & 7


def find_contours_external(mask) -> List[np.ndarray]:
    """``cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_SIMPLE)[0]`` for a 2-D ``mask`` (nonzero is
    foreground): the outer border of each 8-connected component that no
    other component's hole holds, as int32 ``[n, 1, 2]`` (x, y) points
    where the border turns, each traced counterclockwise on the screen
    from its first pixel in raster order; the list in OpenCV's order (the
    last found first).

    The raster scan and the marks are OpenCV's: a border starts where a 0
    precedes a 1, unless the last traced pixel met on the row is a left
    border pixel (then the start lies inside a traced component, in a
    hole)."""
    m = np.asarray(mask)
    if m.ndim != 2:
        raise ValueError(f"expected a 2-D mask, got shape {m.shape}")
    ys, xs = np.nonzero(m)
    if not len(ys):
        return []
    y0, x0 = int(ys.min()), int(xs.min())
    crop = m[y0:int(ys.max()) + 1, x0:int(xs.max()) + 1] != 0
    h, w = crop.shape[0] + 2, crop.shape[1] + 2
    padded = np.zeros((h, w), np.int8)
    padded[1:-1, 1:-1] = crop
    img = padded.ravel().tolist()
    found = []
    for y in range(1, h - 1):
        row = y * w
        lnbd = row          # the row's border column holds 0
        prev = 0
        for x in range(1, w - 1):
            p = img[row + x]
            if p == prev:
                continue
            if prev == 0 and p == 1:
                if img[lnbd] <= 0:
                    found.append(_follow(img, w, row + x, x, y))
                    # the scan goes on past the start, from its new mark
                    prev = img[row + x]
                    continue
            elif p == 0 and prev >= 1 and prev & -2:
                # a hole's border: not traced, but it names the last border
                lnbd = row + x - 1
            prev = p
            if prev & -2:
                lnbd = row + x
    return [np.asarray([(px + x0 - 1, py + y0 - 1) for px, py in pts],
                       np.int32).reshape(-1, 1, 2)
            for pts in reversed(found)]
