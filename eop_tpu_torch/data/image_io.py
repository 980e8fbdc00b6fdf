"""Image files without a decoding library (the port's ``cv2.imread`` and
``cv2.imdecode``).

:func:`imread` and :func:`imdecode` return what ``cv2.imread(path)`` and
``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` return: BGR uint8 ``[H, W, 3]``,
turned by the EXIF orientation where the file has one.  The format comes
from the data's signature, as OpenCV picks it, not from a file's extension,
so a BMP stored as ``000000000001.jpg`` (the name ``COCO24PDataset`` gives
every image) reads the same in both packages.

* 24-bit uncompressed BMP and binary PPM (P6, maxval 255) decode with numpy;
* baseline JPEG and PNG decode with the port's host library
  ``csrc/image_decode.cpp`` (built by ``_build`` on first use, bound with
  ctypes), held bit-equal to OpenCV's libjpeg-turbo and libpng decode in the
  tests; PNG's IDAT stream is inflated with the standard library's ``zlib``;
* any other format, progressive and arithmetic-coded JPEG among them,
  decodes with OpenCV where it is installed and raises
  :class:`UnsupportedImageError`, naming the format, where it is not.

Corrupt data raises ``ValueError``.  Unlike libjpeg, which pads truncated
entropy-coded data with zeros and warns, the port's JPEG decoder raises.

:func:`declared_size` reads ``(width, height)`` of the decoded image (the
EXIF orientation swaps them for orientations 5-8) from the headers of the
formats above, without decoding the pixels; :func:`image_size` does so from
the head of a file.
"""

from __future__ import annotations

import ctypes
import re
import zlib
from typing import Optional, Tuple

import numpy as np

from .. import _build

# "P6" <ws> width <ws> height <ws> maxval <one ws>, comments from '#' to EOL
_PPM_HEADER = re.compile(
    rb"P6(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+"
    rb"(\d+)\s")
_JPEG_SIGNATURE = b"\xff\xd8"
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# status codes of csrc/image_decode.cpp: formats it does not decode ...
_UNSUPPORTED = {
    4: "progressive JPEG", 5: "lossless JPEG", 6: "arithmetic-coded JPEG",
    7: "hierarchical JPEG", 8: "JPEG of a sample precision other than 8 bits",
    9: "JPEG with 2 or 4 components (CMYK / YCCK)",
    10: "JPEG with a sampling factor above 2",
}
# ... and data it finds corrupt
_CORRUPT = {
    1: "not a JPEG", 2: "corrupt JPEG data", 3: "truncated JPEG data",
    11: "corrupt JPEG data (bad Huffman code)",
    12: "JPEG scan refers to an undefined table", 13: "JPEG size mismatch",
    14: "out of memory",
    20: "corrupt PNG data (bad filter type)", 21: "truncated PNG image data",
    22: "corrupt PNG data (palette index out of range)",
    23: "corrupt PNG header",
}
# OpenCV's default cap on decoded pixels (CV_IO_MAX_IMAGE_PIXELS)
_MAX_PIXELS = 1 << 30
# PNG colour type -> allowed bit depths, samples per pixel
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# image_size reads this much of a file first: the SOF and APP1 EXIF of a
# JPEG, the chunks before a PNG's IDAT
_HEAD_BYTES = 64 * 1024


class UnsupportedImageError(RuntimeError):
    """A format the port does not decode itself, where OpenCV is absent."""


def _decoder() -> ctypes.CDLL:
    lib = _build.load("image_decode")
    if lib.png_decode.argtypes is None:  # declare once
        buf, size, i32 = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int32
        out = ctypes.c_void_p
        lib.jpeg_info.argtypes = [buf, size, ctypes.POINTER(i32)]
        lib.jpeg_decode.argtypes = [buf, size, out, i32, i32]
        lib.png_decode.argtypes = [buf, size, i32, i32, i32, i32, i32, buf,
                                   i32, out]
        for fn in (lib.jpeg_info, lib.png_decode, lib.jpeg_decode):
            fn.restype = ctypes.c_int
    return lib


def load_decoder() -> None:
    """Build (first time) and load the decoder library: a process that is
    about to start workers calls this once, so they load the built file."""
    _decoder()


def _bmp_header(head: bytes) -> Optional[Tuple[int, int, int, bool, bool]]:
    """(pixel offset, width, height, bottom_up, plain) of a BMP with a
    BITMAPINFOHEADER or later, ``plain`` where it is 24-bit uncompressed
    (numpy decodes it); None for any other file."""
    if len(head) < 34 or head[:2] != b"BM":
        return None
    offset = int.from_bytes(head[10:14], "little")
    dib = int.from_bytes(head[14:18], "little")
    width = int.from_bytes(head[18:22], "little", signed=True)
    height = int.from_bytes(head[22:26], "little", signed=True)
    if dib < 40 or width <= 0 or height == 0:
        return None
    bpp = int.from_bytes(head[28:30], "little")
    compression = int.from_bytes(head[30:34], "little")
    return (offset, width, abs(height), height > 0,
            bpp == 24 and compression == 0)


def _ppm_header(head: bytes) -> Optional[Tuple[int, int, int]]:
    """(pixel offset, width, height) of a binary P6 PPM with maxval 255."""
    m = _PPM_HEADER.match(head)
    if m is None or int(m.group(3)) != 255:
        return None
    return m.end(), int(m.group(1)), int(m.group(2))


def _format_name(data: bytes) -> str:
    for sig, name in ((b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                      (b"GIF8", "GIF"), (b"\x00\x00\x00\x0cjP", "JPEG 2000"),
                      (b"BM", "BMP other than 24-bit uncompressed"),
                      (b"P", "PNM other than binary P6 with maxval 255")):
        if data.startswith(sig):
            return name
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    return "this image format"


def _exif_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112) of the first IFD of an EXIF block (TIFF
    layout); 1 where it is absent or unreadable, as OpenCV's ExifReader."""
    if tiff.startswith(b"Exif\x00\x00"):
        tiff = tiff[6:]
    order = {b"II": "little", b"MM": "big"}.get(tiff[:2])
    if (order is None or len(tiff) < 8
            or int.from_bytes(tiff[2:4], order) != 42):
        return 1
    ifd = int.from_bytes(tiff[4:8], order)
    if ifd + 2 > len(tiff):
        return 1
    for i in range(int.from_bytes(tiff[ifd:ifd + 2], order)):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        if int.from_bytes(tiff[at:at + 2], order) == 0x0112:
            value = int.from_bytes(tiff[at + 8:at + 10], order)
            return value if 1 <= value <= 8 else 1
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ExifTransform``: 2-4 flip, 5-8 transpose and then flip."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flips.get(orientation, ()):
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def _check_pixels(width: int, height: int) -> None:
    if width * height > _MAX_PIXELS:
        raise ValueError(f"image {width}x{height} exceeds {_MAX_PIXELS} "
                         "pixels")


def _jpeg_info(data: bytes):
    """(width, height, orientation) from a JPEG's headers."""
    info = (ctypes.c_int32 * 4)()
    status = _decoder().jpeg_info(data, len(data), info)
    if status:
        raise ValueError(_CORRUPT.get(status, f"JPEG status {status}"))
    width, height, exif_at, exif_len = info
    orientation = 1
    if exif_at >= 0 and exif_len > 6:
        # OpenCV parses the first APP1 segment past its 6-byte "Exif\0\0"
        orientation = _exif_orientation(data[exif_at + 6:exif_at + exif_len])
    return width, height, orientation


def _png_chunks(data: bytes, headers_only: bool):
    """(IHDR fields, palette, IDAT bytes, orientation) of a PNG; CRC errors
    in critical chunks raise, ancillary ones are skipped (libpng's
    defaults).  ``headers_only`` stops at the first IDAT, unread."""
    pos, ihdr, palette, idat, orientation = 8, None, b"", [], 1
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG data (no IEND chunk)")
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind == b"IDAT" and headers_only:
            break
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        pos += 12 + length
        if len(crc) < 4:
            raise ValueError(f"truncated PNG data in its {kind!r} chunk")
        if zlib.crc32(kind + body) != int.from_bytes(crc, "big"):
            if not kind[0] & 0x20:  # upper-case first letter: critical
                raise ValueError(f"PNG CRC error in its {kind!r} chunk")
            continue
        if kind == b"IHDR" and len(body) == 13:
            ihdr = (int.from_bytes(body[0:4], "big"),
                    int.from_bytes(body[4:8], "big"), *body[8:13])
        elif kind == b"PLTE":
            palette = body
        elif kind == b"eXIf" and not idat:
            orientation = _exif_orientation(body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("corrupt PNG header (no IHDR chunk)")
    width, height, depth, color, compression, filt, interlace = ihdr
    if (width <= 0 or height <= 0 or depth not in _PNG_DEPTHS.get(color, ())
            or compression or filt or interlace > 1
            or (color == 3 and not palette)):
        raise ValueError(f"corrupt PNG header {ihdr}")
    return ihdr, palette, b"".join(idat), orientation


def _png_inflated_size(width: int, height: int, depth: int, color: int,
                       interlace: int) -> int:
    """Bytes of the filtered rows the IHDR declares: one filter byte and the
    packed samples a row, over each Adam7 pass or the one image."""
    bits = depth * _PNG_CHANNELS[color]
    size = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        if width > x0 and height > y0:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            size += ph * (1 + (pw * bits + 7) // 8)
    return size


def _decode_png(data: bytes) -> np.ndarray:
    (width, height, depth, color, _, _, interlace), palette, idat, \
        orientation = _png_chunks(data, headers_only=False)
    _check_pixels(width, height)
    # inflate no more than the header's rows: a small image whose IDAT
    # inflates to gigabytes decodes in bounded memory; libpng also decodes
    # the declared rows and warns of the rest ("Too much image data")
    try:
        raw = zlib.decompressobj().decompress(
            idat, _png_inflated_size(width, height, depth, color, interlace))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    out = np.empty((height, width, 3), np.uint8)
    status = _decoder().png_decode(raw, len(raw), width, height, depth, color,
                                   interlace, palette, len(palette) // 3,
                                   out.ctypes.data)
    if status:
        raise ValueError(_CORRUPT.get(status, f"PNG status {status}"))
    return _orient(out, orientation)


def _decode_jpeg(data: bytes) -> np.ndarray:
    width, height, orientation = _jpeg_info(data)
    _check_pixels(width, height)
    out = np.empty((height, width, 3), np.uint8)
    status = _decoder().jpeg_decode(data, len(data), out.ctypes.data, width,
                                    height)
    if status in _UNSUPPORTED:
        return _cv2_decode(data, _UNSUPPORTED[status])
    if status:
        raise ValueError(_CORRUPT.get(status, f"JPEG status {status}"))
    return _orient(out, orientation)


def _cv2_decode(data: bytes, what: str) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        raise UnsupportedImageError(
            f"decoding {what} needs OpenCV (cv2), which is not installed; "
            "baseline JPEG, PNG, 24-bit BMP and binary PPM (P6) decode "
            "without it") from None
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"not an image OpenCV can decode ({what})")
    return img


def imdecode(buf) -> np.ndarray:
    """BGR uint8 ``[H, W, 3]`` from an encoded image in memory, as
    ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``."""
    data = bytes(buf)
    bmp = _bmp_header(data[:64])
    if bmp is not None and bmp[4]:
        offset, w, h, bottom_up, _ = bmp
        stride = (3 * w + 3) // 4 * 4          # rows pad to 4 bytes
        rows = np.frombuffer(data, np.uint8, stride * h, offset)
        img = rows.reshape(h, stride)[:, :3 * w].reshape(h, w, 3)
        return np.ascontiguousarray(img[::-1] if bottom_up else img)
    ppm = _ppm_header(data[:512])
    if ppm is not None:
        offset, w, h = ppm
        rgb = np.frombuffer(data, np.uint8, 3 * w * h, offset)
        return np.ascontiguousarray(rgb.reshape(h, w, 3)[:, :, ::-1])
    if data.startswith(_PNG_SIGNATURE):
        return _decode_png(data)
    if data.startswith(_JPEG_SIGNATURE):
        return _decode_jpeg(data)
    return _cv2_decode(data, _format_name(data))


def imread(path: str) -> np.ndarray:
    """BGR uint8 ``[H, W, 3]``, as ``cv2.imread(path)``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return imdecode(data)
    except (ValueError, UnsupportedImageError) as e:
        raise type(e)(f"{path}: {e}") from None


def declared_size(data: bytes) -> Optional[Tuple[int, int]]:
    """``(width, height)`` of the image :func:`imdecode` returns, read from
    the headers of BMP, binary PPM, JPEG (of any coding) and PNG data
    without decoding it; None for any other format.  A corrupt or truncated
    header raises ``ValueError``."""
    bmp = _bmp_header(data[:64])
    if bmp is not None:
        return bmp[1], bmp[2]
    ppm = _ppm_header(data[:512])
    if ppm is not None:
        return ppm[1], ppm[2]
    if data.startswith(_JPEG_SIGNATURE):
        width, height, orientation = _jpeg_info(data)
    elif data.startswith(_PNG_SIGNATURE):
        ihdr, _, _, orientation = _png_chunks(data, headers_only=True)
        width, height = ihdr[:2]
    else:
        return None
    return (height, width) if orientation >= 5 else (width, height)


def image_size(path: str) -> Tuple[int, int]:
    """``(width, height)`` of the image :func:`imread` returns, from the
    file's header where the format is one the port decodes itself: the
    first 64 KiB of the file, all of it where the header runs past them."""
    with open(path, "rb") as f:
        data = f.read(_HEAD_BYTES)
        try:
            size = declared_size(data)
        except ValueError:
            rest = f.read()
            if not rest:
                raise
            size = declared_size(data + rest)
    if size is None:
        img = imread(path)
        return img.shape[1], img.shape[0]
    return size
