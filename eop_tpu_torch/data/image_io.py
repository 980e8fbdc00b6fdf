"""Image files without a decoding library (the port's ``cv2.imread``).

:func:`imread` returns what ``cv2.imread(path)`` returns: BGR uint8
``[H, W, 3]``.  The format comes from the file's signature, as OpenCV picks
it, not from its extension, so a BMP stored as ``000000000001.jpg`` (the
name ``COCO24PDataset`` gives every image) reads the same in both packages.

* 24-bit uncompressed BMP and binary PPM (P6, maxval 255) decode with numpy
  on every machine;
* any other format decodes with OpenCV where it is installed, and raises,
  naming the format it needs, where it is not.

:func:`image_size` reads ``(width, height)`` from the header of the formats
above, without decoding the pixels.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

# "P6" <ws> width <ws> height <ws> maxval <one ws>, comments from '#' to EOL
_PPM_HEADER = re.compile(
    rb"P6(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+"
    rb"(\d+)\s")


def _bmp_header(head: bytes) -> Optional[Tuple[int, int, int, bool]]:
    """(pixel offset, width, height, bottom_up) of a 24-bit uncompressed BMP
    with a BITMAPINFOHEADER or later; None for any other file."""
    if len(head) < 34 or head[:2] != b"BM":
        return None
    offset = int.from_bytes(head[10:14], "little")
    dib = int.from_bytes(head[14:18], "little")
    if dib < 40:
        return None
    width = int.from_bytes(head[18:22], "little", signed=True)
    height = int.from_bytes(head[22:26], "little", signed=True)
    bpp = int.from_bytes(head[28:30], "little")
    compression = int.from_bytes(head[30:34], "little")
    if bpp != 24 or compression != 0 or width <= 0 or height == 0:
        return None
    return offset, width, abs(height), height > 0


def _ppm_header(head: bytes) -> Optional[Tuple[int, int, int]]:
    """(pixel offset, width, height) of a binary P6 PPM with maxval 255."""
    m = _PPM_HEADER.match(head)
    if m is None or int(m.group(3)) != 255:
        return None
    return m.end(), int(m.group(1)), int(m.group(2))


def _cv2_imread(path: str) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: decoding this image format needs OpenCV (cv2), which "
            "is not installed; 24-bit BMP and binary PPM (P6) decode "
            "without it") from None
    img = cv2.imread(path)
    if img is None:
        raise ValueError(f"{path}: not an image OpenCV can decode")
    return img


def imread(path: str) -> np.ndarray:
    """BGR uint8 ``[H, W, 3]``, as ``cv2.imread(path)``."""
    with open(path, "rb") as f:
        data = f.read()
    bmp = _bmp_header(data[:64])
    if bmp is not None:
        offset, w, h, bottom_up = bmp
        stride = (3 * w + 3) // 4 * 4          # rows pad to 4 bytes
        rows = np.frombuffer(data, np.uint8, stride * h, offset)
        img = rows.reshape(h, stride)[:, :3 * w].reshape(h, w, 3)
        return np.ascontiguousarray(img[::-1] if bottom_up else img)
    ppm = _ppm_header(data[:512])
    if ppm is not None:
        offset, w, h = ppm
        rgb = np.frombuffer(data, np.uint8, 3 * w * h, offset)
        return np.ascontiguousarray(rgb.reshape(h, w, 3)[:, :, ::-1])
    return _cv2_imread(path)


def image_size(path: str) -> Tuple[int, int]:
    """``(width, height)`` of an image file, from its header where the
    format is one :func:`imread` decodes itself."""
    with open(path, "rb") as f:
        head = f.read(512)
    bmp = _bmp_header(head)
    if bmp is not None:
        return bmp[1], bmp[2]
    ppm = _ppm_header(head)
    if ppm is not None:
        return ppm[1], ppm[2]
    img = _cv2_imread(path)
    return img.shape[1], img.shape[0]
