"""Box drawing (counterpart of ``eop_tpu/utils/visualize.py``'s ``vis``).

The boxes are drawn with numpy, pixel for pixel what
``cv2.rectangle(img, p0, p1, color, 2)`` draws.  The label bar's width
comes from ``cv2.getTextSize`` and its text from ``cv2.putText`` (the
Hershey font), so the bar and the text are drawn only where cv2 imports
(inside the function, as ``data/image_io.py`` does for the formats its own
decoder lacks); without it only the boxes are drawn, and one log line says
so.  The class colours are ``eop_tpu``'s table (its golden-ratio hue
walk).
"""

from __future__ import annotations

import colorsys

import numpy as np

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


def vis(img, boxes, scores, cls_ids, conf=0.5, class_names=None):
    """Draw the xyxy ``boxes`` scoring at least ``conf`` on ``img`` (BGR
    uint8, in place), each with a ``name:score%`` label where cv2 is
    installed."""
    try:
        import cv2
    except ImportError:
        cv2 = None
        if not _warned:
            _warned.append(True)
            logger.info("vis: OpenCV is not installed; drawing the boxes "
                        "without their labels")
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
