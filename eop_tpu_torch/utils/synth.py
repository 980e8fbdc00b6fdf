"""Synthetic 24-point data.

``synthetic_24p_batch`` (counterpart of ``eop_tpu/utils/synth.py``): one
training batch on the device, the label row layout ``[cls, cx, cy,
24 x (x, y)]`` zero-padded to ``max_labels`` rows, with the same ranges.
The random stream is a ``torch.Generator``'s, not JAX's, so a comparison of
the two packages feeds both the same numpy arrays instead.

``write_24p_dataset``: a seeded dataset on disk in the txt-label layout
(``tools/make_synth_datasets.py``'s recipe), its images under ``.jpg`` names
as BMP, baseline JPEG or PNG content, written with numpy and the standard
library alone (``write_bmp``, ``write_jpeg``, ``write_png``) so that a
machine without an image library writes and reads it.  ``write_coco_dataset``:
the bbox family's seeded COCO-format dataset (``make_synth_datasets.py``'s
``make_coco`` recipe: coloured rectangles on dark noise, the class is the
colour).  ``write_voc_devkit``: a seeded PASCAL VOC devkit of the same
kind of images, with VOC's xml annotations.  ``write_featuremap_fixture``: the feature-map study's
single-image COCO fixture with polygon segmentations.  ``LabelOracle``: an
``infer_fn`` that answers with a dataset's
labels, for which an evaluator must give AP 1.
"""

from __future__ import annotations

import json
import math
import os
import zlib

import numpy as np
import torch


def synthetic_24p_batch(generator: torch.Generator, batch: int,
                        size: int = 640, ngt: int = 8, max_labels: int = 50,
                        r_lo: float = 10.0, r_hi: float = 80.0):
    """Returns (images ``[B, S, S, 3]`` f32 in 0..255, labels
    ``[B, max_labels, 51]`` f32 with ``ngt`` valid star-polygon rows), on the
    generator's device."""
    dev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    imgs = uniform((batch, size, size, 3), 0.0, 255.0)
    margin = r_hi + 20.0
    cx = uniform((batch, max_labels, 1), margin, size - margin)
    cy = uniform((batch, max_labels, 1), margin, size - margin)
    r = uniform((batch, max_labels, 24), r_lo, r_hi)
    theta = torch.arange(24, device=dev) * (2 * math.pi / 24)
    pts = torch.stack([cx + r * torch.cos(theta), cy + r * torch.sin(theta)],
                      dim=-1).reshape(batch, max_labels, 48)
    labels = torch.cat([torch.zeros_like(cx), cx, cy, pts], dim=-1)
    keep = torch.arange(max_labels, device=dev)[None, :, None] < ngt
    return imgs, labels * keep


def write_bmp(path: str, img: np.ndarray) -> None:
    """BGR uint8 [H, W, 3] -> a 24-bit uncompressed bottom-up BMP."""
    h, w, _ = img.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[::-1].reshape(h, 3 * w)
    le = lambda v, n: int(v).to_bytes(n, "little", signed=True)  # noqa: E731
    header = (b"BM" + le(54 + rows.size, 4) + le(0, 4) + le(54, 4)
              + le(40, 4) + le(w, 4) + le(h, 4) + le(1, 2) + le(24, 2)
              + le(0, 4) + le(rows.size, 4) + le(2835, 4) + le(2835, 4)
              + le(0, 4) + le(0, 4))
    with open(path, "wb") as f:
        f.write(header + rows.tobytes())


# ITU T.81 Annex K: quantization tables (natural order) and the Huffman
# tables as (code counts for lengths 1..16, symbols)
_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QUANT_CHROMA = np.full(64, 99)
_QUANT_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_HUFF_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                 tuple(range(12)))
_HUFF_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                   tuple(range(12)))
_HUFF_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
                 bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_HUFF_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                   bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
# zigzag position -> natural (row-major) index
_ZIGZAG = np.array(sorted(range(64), key=lambda i: (
    i // 8 + i % 8, (i % 8 if (i // 8 + i % 8) % 2 == 0 else i // 8))))
_BIT_LENGTH = np.array([0] + [int(v).bit_length() for v in range(1, 1 << 16)],
                       np.int64)


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG's quality scaling (jcparam.c), limited to baseline's 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: np.ndarray, final: bool) -> np.ndarray:
    """jfdctint.c's integer forward DCT along the last axis: the first pass
    (``final`` False) keeps PASS1_BITS (2) more bits, the second removes
    them; CONST_BITS 13."""
    shift = 15 if final else 11
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = np.empty_like(d)
    if final:
        out[..., 0] = _descale(t10 + t11, 2)
        out[..., 4] = _descale(t10 - t11, 2)
    else:
        out[..., 0] = (t10 + t11) << 2
        out[..., 4] = (t10 - t11) << 2
    z1 = (t12 + t13) * 4433
    out[..., 2] = _descale(z1 + t13 * 6270, shift)
    out[..., 6] = _descale(z1 - t12 * 15137, shift)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * 9633
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    out[..., 7] = _descale(t4 * 2446 + z1 + z3, shift)
    out[..., 5] = _descale(t5 * 16819 + z2 + z4, shift)
    out[..., 3] = _descale(t6 * 25172 + z2 + z3, shift)
    out[..., 1] = _descale(t7 * 12299 + z1 + z4, shift)
    return out


def _quantize(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """jcdctmgr.c: the 8x-scaled DCT over 8 q, rounded half away from 0."""
    div = q * 8
    mag = (np.abs(coef) + (div >> 1)) // div
    return np.where(coef < 0, -mag, mag)


def _huffman_codes(table):
    """(codes[256], lengths[256]) of a (counts, symbols) table."""
    counts, symbols = table
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """MSB-first concatenation of ``lengths[i]``-bit ``values[i]`` (each at
    most 32 bits), padded with 1-bits to a byte, with JPEG's 0xFF 0x00
    stuffing."""
    offsets = np.cumsum(lengths) - lengths
    total = int(offsets[-1] + lengths[-1]) if len(lengths) else 0
    words = (total + 31) // 32 + 1
    # each value inside a 64-bit window that starts at its 32-bit word; the
    # fields do not overlap, so summing them sets their bits
    window = values.astype(np.uint64) << (
        64 - (offsets & 31) - lengths).astype(np.uint64)
    at = offsets >> 5
    acc = (np.bincount(at, (window >> np.uint64(32)).astype(np.float64),
                       words)
           + np.bincount(at + 1, (window & np.uint64(0xFFFFFFFF)).astype(
               np.float64), words + 1)[:words])
    data = np.frombuffer(acc.astype(np.uint64).astype(">u4").tobytes(),
                         np.uint8)[:(total + 7) // 8].copy()
    if total % 8:
        data[-1] |= 0xFF >> (total % 8)
    ff = np.flatnonzero(data == 0xFF)
    out = np.repeat(data, 1 + (data == 0xFF))
    out[ff + np.arange(len(ff)) + 1] = 0
    return out.tobytes()


def encode_jpeg(img: np.ndarray, quality: int = 95,
                sampling: str = "4:2:0") -> bytes:
    """A baseline JPEG of a BGR uint8 ``[H, W, 3]`` image: JFIF YCbCr,
    ``sampling`` ``"4:2:0"`` (OpenCV's default) or ``"4:4:4"``, the Annex K
    quantization tables at IJG's ``quality`` scaling and the Annex K Huffman
    tables, one interleaved scan; libjpeg's integer colour conversion and
    forward DCT, vectorized over all blocks, so the bytes are the same on
    every machine.  Valid and deterministic, not bit-equal to another
    encoder (its downsampling and Huffman packing are its own)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected BGR uint8 [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    if sampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"sampling {sampling!r}: '4:2:0' or '4:4:4'")
    h, w, _ = img.shape
    sub = 2 if sampling == "4:2:0" else 1
    mcu = 8 * sub
    mh, mw = -(-h // mcu), -(-w // mcu)
    px = np.pad(img.astype(np.int64),
                ((0, mh * mcu - h), (0, mw * mcu - w), (0, 0)), mode="edge")
    b, g, r = px[..., 0], px[..., 1], px[..., 2]
    # jccolor.c's fixed-point RGB -> YCbCr (SCALEBITS 16)
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16
    if sub == 2:
        cb = (cb.reshape(mh * 8, 2, mw * 8, 2).sum((1, 3)) + 2) >> 2
        cr = (cr.reshape(mh * 8, 2, mw * 8, 2).sum((1, 3)) + 2) >> 2
    quant = [_quant_table(_QUANT_LUMA, quality),
             _quant_table(_QUANT_CHROMA, quality)]

    def blocks(plane, q):
        """[mh, mw, sub*sub (or 1), 64] quantized zigzag coefficients in
        each MCU's block order."""
        n = plane.shape[0] // 8, plane.shape[1] // 8
        blk = plane.reshape(n[0], 8, n[1], 8).transpose(0, 2, 1, 3) - 128
        blk = _fdct_1d(blk, final=False)
        blk = _fdct_1d(blk.swapaxes(-1, -2), final=True).swapaxes(-1, -2)
        coef = _quantize(blk.reshape(*n, 64), q)[..., _ZIGZAG]
        k = n[0] // mh
        return coef.reshape(mh, k, mw, k, 64).transpose(0, 2, 1, 3, 4) \
            .reshape(mh, mw, k * k, 64)

    mcus = np.concatenate([blocks(y, quant[0]), blocks(cb, quant[1]),
                           blocks(cr, quant[1])], axis=2)
    comp = np.array([0] * (sub * sub) + [1, 2])
    coef = mcus.reshape(-1, 64)
    comp = np.tile(comp, mh * mw)
    table = np.minimum(comp, 1)  # 0: luma tables, 1: chroma tables
    dc = coef[:, 0].copy()
    for c in range(3):
        idx = np.flatnonzero(comp == c)
        dc[idx] = np.diff(coef[idx, 0], prepend=0)

    def magnitude(v):
        """(JPEG size category, its extra bits) of each value."""
        s = _BIT_LENGTH[np.abs(v)]
        return s, np.where(v < 0, v + (1 << s) - 1, v)

    dc_codes = [_huffman_codes(t) for t in (_HUFF_DC_LUMA, _HUFF_DC_CHROMA)]
    ac_codes = [_huffman_codes(t) for t in (_HUFF_AC_LUMA, _HUFF_AC_CHROMA)]

    def items(symbols, tables, size, bits):
        code = np.where(tables == 0, tables_codes[0][0][symbols],
                        tables_codes[1][0][symbols])
        length = np.where(tables == 0, tables_codes[0][1][symbols],
                          tables_codes[1][1][symbols])
        return (code << size) | bits, length + size

    keys, values, lengths = [], [], []
    # DC: one item a block
    s, extra = magnitude(dc)
    tables_codes = dc_codes
    v, n = items(s, table, s, extra)
    blocks_idx = np.arange(len(coef))
    keys.append(blocks_idx * 1024)
    values.append(v)
    lengths.append(n)
    tables_codes = ac_codes
    # AC: each nonzero coefficient, after 16-zero runs (ZRL) where needed
    blk, k = np.nonzero(coef[:, 1:])
    k = k + 1
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    s, extra = magnitude(coef[blk, k])
    v, n = items((run % 16) * 16 + s, table[blk], s, extra)
    keys.append(blk * 1024 + k * 8 + 7)
    values.append(v)
    lengths.append(n)
    zrl = run // 16
    zblk = np.repeat(blk, zrl)
    zk = np.repeat(k, zrl)
    zi = np.arange(len(zblk)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    zero = np.zeros(len(zblk), np.int64)
    v, n = items(zero + 0xF0, table[zblk], zero, zero)
    keys.append(zblk * 1024 + zk * 8 + zi)
    values.append(v)
    lengths.append(n)
    # EOB where the block's last coefficient is zero
    eob = np.flatnonzero(coef[:, 63] == 0)
    zero = np.zeros(len(eob), np.int64)
    v, n = items(zero, table[eob], zero, zero)
    keys.append(eob * 1024 + 1000)
    values.append(v)
    lengths.append(n)
    order = np.argsort(np.concatenate(keys), kind="stable")
    data = _pack_bits(np.concatenate(values)[order],
                      np.concatenate(lengths)[order])

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate(quant):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            q.astype(np.uint8)[_ZIGZAG].tolist())))
    sof = h.to_bytes(2, "big") + w.to_bytes(2, "big") + b"\x03"
    for c in range(3):
        factors = (sub << 4 | sub) if c == 0 else 0x11
        sof += bytes([c + 1, factors, min(c, 1)])
    out.append(_segment(0xC0, b"\x08" + sof))
    for cls, tabs in ((0, (_HUFF_DC_LUMA, _HUFF_DC_CHROMA)),
                      (1, (_HUFF_AC_LUMA, _HUFF_AC_CHROMA))):
        for t, (counts, symbols) in enumerate(tabs):
            out.append(_segment(0xC4, bytes([cls << 4 | t, *counts])
                                + bytes(symbols)))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [data, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95,
               sampling: str = "4:2:0") -> None:
    """:func:`encode_jpeg` to a file."""
    data = encode_jpeg(img, quality, sampling)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of a BGR uint8 ``[H, W, 3]`` image; row ``i`` uses
    filter type ``i % 5`` (None, Sub, Up, Average, Paeth), so every filter
    occurs; the stream is deflated with ``zlib``."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected BGR uint8 [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    x = img[:, :, ::-1].reshape(h, 3 * w).astype(np.int32)
    zero_col = np.zeros((h, 3), np.int32)
    left = np.concatenate([zero_col, x[:, :-3]], axis=1)
    up = np.concatenate([np.zeros((1, 3 * w), np.int32), x[:-1]], axis=0)
    upleft = np.concatenate([zero_col, up[:, :-3]], axis=1)
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    kind = np.arange(h) % 5
    rows = (x - preds[kind, np.arange(h)]) & 0xFF
    raw = np.concatenate([kind[:, None], rows], axis=1).astype(np.uint8)

    def chunk(name: bytes, body: bytes) -> bytes:
        return (len(body).to_bytes(4, "big") + name + body
                + zlib.crc32(name + body).to_bytes(4, "big"))

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """:func:`encode_png` to a file."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


_WRITERS = {"bmp": write_bmp, "jpeg": write_jpeg, "png": write_png}
_BY_EXTENSION = {".bmp": "bmp", ".jpg": "jpeg", ".jpeg": "jpeg",
                 ".png": "png"}


def write_image(path: str, img: np.ndarray) -> None:
    """A BGR uint8 ``[H, W, 3]`` image to ``path`` in the format its
    extension names: ``.png`` (:func:`write_png`), ``.jpg`` / ``.jpeg``
    (:func:`write_jpeg`, quality 95, 4:2:0, as ``cv2.imwrite``'s default
    quality) or ``.bmp`` (:func:`write_bmp`)."""
    fmt = _BY_EXTENSION.get(os.path.splitext(path)[1].lower())
    if fmt is None:
        raise ValueError(f"{path}: write .png, .jpg, .jpeg or .bmp")
    _WRITERS[fmt](path, img)


def _write_job(job) -> None:
    fmt, path, img = job
    _WRITERS[fmt](path, img)


def _write_all(jobs, workers: int) -> None:
    """Encode and write ``(fmt, path, image)`` jobs, in ``workers`` spawned
    processes where more than one (the files are the same either way)."""
    if workers <= 1:
        for job in jobs:
            _write_job(job)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(workers, multiprocessing.get_context(
            "spawn")) as pool:
        list(pool.map(_write_job, jobs))


def synthetic_24p_image(rng: np.random.RandomState, hw):
    """One image of ``hw``: 1-3 discs in class colours on dark noise, and its
    label rows ``[cls, cx, cy, 24 x (x, y)]`` normalized to the image
    (``tools/make_synth_datasets.py``'s recipe)."""
    h, w = hw
    colors = ((0, 0, 255), (0, 255, 0), (255, 0, 0))
    ang = np.arange(24) * 15.0 * np.pi / 180.0
    yy, xx = np.ogrid[:h, :w]
    img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
    rows = []
    for _ in range(rng.randint(1, 4)):
        cls = rng.randint(0, 3)
        r = rng.uniform(min(h, w) * 0.07, min(h, w) * 0.18)
        cx = rng.uniform(r + 5, w - r - 5)
        cy = rng.uniform(r + 5, h - r - 5)
        img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = colors[cls]
        px, py = cx + r * np.cos(ang), cy + r * np.sin(ang)
        rows.append([cls, cx / w, cy / h]
                    + [v for xy in zip(px / w, py / h) for v in xy])
    return img, np.asarray(rows)


def write_24p_dataset(root: str, n: int, hw, seed: int = 0,
                      fmt: str = "bmp", workers: int = 1):
    """``n`` seeded images of ``hw`` (:func:`synthetic_24p_image`) with
    their labels: images ``root/imgs/{i:012}.jpg`` of ``fmt`` content
    (``"bmp"``, ``"jpeg"``: quality 95, 4:2:0, or ``"png"``), encoded in
    ``workers`` processes, labels ``root/labels/{i:012}.txt``.  Returns
    (image dir, label dir)."""
    if fmt not in _WRITERS:
        raise ValueError(f"fmt {fmt!r}: one of {sorted(_WRITERS)}")
    rng = np.random.RandomState(seed)
    img_dir, lab_dir = os.path.join(root, "imgs"), os.path.join(root, "labels")
    os.makedirs(img_dir)
    os.makedirs(lab_dir)
    jobs = []
    for i in range(n):
        img, rows = synthetic_24p_image(rng, hw)
        jobs.append((fmt, os.path.join(img_dir, f"{i:012}.jpg"), img))
        np.savetxt(os.path.join(lab_dir, f"{i:012}.txt"), rows, fmt="%.6f")
    _write_all(jobs, workers)
    return img_dir, lab_dir


def class_colours(num_classes: int, seed: int = 0) -> np.ndarray:
    """``num_classes`` distinct bright BGR colours, seeded."""
    rng = np.random.RandomState(seed)
    out = set()
    while len(out) < num_classes:
        out.add(tuple(int(v) for v in rng.randint(80, 256, 3)))
    return np.array(sorted(out), np.uint8)[rng.permutation(num_classes)]


def write_coco_dataset(root: str, n_train: int, n_val: int, hw,
                       num_classes: int = 80, seed: int = 0,
                       fmt: str = "jpeg", workers: int = 1):
    """A seeded COCO-format dataset under ``root``: ``train2017/`` and
    ``val2017/`` images of ``hw`` (``{id:012}.jpg`` names, ``fmt`` content:
    ``"jpeg"`` quality 95 4:2:0, ``"png"`` or ``"bmp"``; encoded in
    ``workers`` processes), each 1 to 4 filled rectangles on dark noise
    whose colour is the class, and
    ``annotations/instances_{train,val}2017.json`` with category ids 1 ..
    ``num_classes``.  Returns ``root``."""
    if fmt not in _WRITERS:
        raise ValueError(f"fmt {fmt!r}: one of {sorted(_WRITERS)}")
    h, w = hw
    # sides from 30 px (less on small images) to 35 % of the image
    side_lo = [min(30, max(4, v // 8)) for v in hw]
    side_hi = [max(lo + 1, int(v * 0.35)) for lo, v in zip(side_lo, hw)]
    colours = class_colours(num_classes, seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    cats = [{"id": c + 1, "name": f"class{c}", "supercategory": "synthetic"}
            for c in range(num_classes)]
    jobs = []
    for split, n, split_seed in (("train2017", n_train, seed),
                                 ("val2017", n_val, seed + 1)):
        rng = np.random.RandomState(split_seed)
        os.makedirs(os.path.join(root, split))
        images, annotations = [], []
        for img_id in range(1, n + 1):
            img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
            for _ in range(rng.randint(1, 5)):
                bw = int(rng.randint(side_lo[1], side_hi[1]))
                bh = int(rng.randint(side_lo[0], side_hi[0]))
                x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
                cat = int(rng.randint(num_classes))
                img[y:y + bh, x:x + bw] = colours[cat]
                annotations.append({
                    "id": len(annotations) + 1, "image_id": img_id,
                    "category_id": cat + 1,
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": float(bw * bh), "iscrowd": 0,
                    "segmentation": [[float(x), float(y), float(x + bw),
                                      float(y), float(x + bw), float(y + bh),
                                      float(x), float(y + bh)]],
                })
            name = f"{img_id:012}.jpg"
            jobs.append((fmt, os.path.join(root, split, name), img))
            images.append({"id": img_id, "width": w, "height": h,
                           "file_name": name})
        with open(os.path.join(root, "annotations",
                               f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": cats}, f)
    _write_all(jobs, workers)
    return root


VOC_POSES = ("Unspecified", "Left", "Right", "Frontal", "Rear")


def write_voc_devkit(root: str, n_trainval: int = 16, n_test: int = 8,
                     hw=(375, 500), years=("2007", "2012"), seed: int = 0):
    """A seeded PASCAL VOC devkit at ``<root>/VOCdevkit``: for each year
    ``VOC<year>/JPEGImages/<stem>.jpg`` (``hw`` baseline JPEG, quality 95,
    4:2:0, written by :func:`write_jpeg`), ``Annotations/<stem>.xml`` and
    ``ImageSets/Main/{trainval,test}.txt`` of ``n_trainval`` and ``n_test``
    images (stems ``000001`` ... for 2007, ``2012_000001`` ... for 2012).
    Each image holds three filled rectangles on dark noise whose colour is
    the class, the classes taken in turn through the 20 VOC names over each
    split (7 images or more hold every class), and, on about a third of
    the images, a fourth of any class marked ``<difficult>1</difficult>``.
    Boxes are VOC's 1-based inclusive pixels; every object has a pose and
    ``truncated``.  Returns the devkit's path."""
    import xml.etree.ElementTree as ET

    from ..data.voc_classes import VOC_CLASSES

    h, w = hw
    side_lo = [min(30, max(4, v // 8)) for v in hw]
    side_hi = [max(lo + 1, int(v * 0.35)) for lo, v in zip(side_lo, hw)]
    colours = class_colours(len(VOC_CLASSES), seed)
    devkit = os.path.join(root, "VOCdevkit")
    for y, year in enumerate(years):
        rng = np.random.RandomState(seed + y)
        year_root = os.path.join(devkit, "VOC" + year)
        for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                              "Main")):
            os.makedirs(os.path.join(year_root, sub), exist_ok=True)
        stem_no = 0
        for split, n in (("trainval", n_trainval), ("test", n_test)):
            stems, turn = [], 0
            for _ in range(n):
                stem_no += 1
                stem = (f"{stem_no:06d}" if year == "2007"
                        else f"{year}_{stem_no:06d}")
                img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
                ann = ET.Element("annotation")
                ET.SubElement(ann, "folder").text = "VOC" + year
                ET.SubElement(ann, "filename").text = stem + ".jpg"
                size = ET.SubElement(ann, "size")
                for tag, v in (("width", w), ("height", h), ("depth", 3)):
                    ET.SubElement(size, tag).text = str(v)
                ET.SubElement(ann, "segmented").text = "0"
                difficult = [0, 0, 0] + ([1] if rng.rand() < 1 / 3 else [])
                for hard in difficult:
                    bw = int(rng.randint(side_lo[1], side_hi[1]))
                    bh = int(rng.randint(side_lo[0], side_hi[0]))
                    x, y0 = (int(rng.randint(0, w - bw)),
                             int(rng.randint(0, h - bh)))
                    if hard:
                        cls = int(rng.randint(len(VOC_CLASSES)))
                    else:
                        cls, turn = turn % len(VOC_CLASSES), turn + 1
                    img[y0:y0 + bh, x:x + bw] = colours[cls]
                    obj = ET.SubElement(ann, "object")
                    ET.SubElement(obj, "name").text = VOC_CLASSES[cls]
                    ET.SubElement(obj, "pose").text = VOC_POSES[
                        rng.randint(len(VOC_POSES))]
                    ET.SubElement(obj, "truncated").text = str(
                        int(rng.rand() < 0.2))
                    ET.SubElement(obj, "difficult").text = str(hard)
                    box = ET.SubElement(obj, "bndbox")
                    for tag, v in (("xmin", x + 1), ("ymin", y0 + 1),
                                   ("xmax", x + bw), ("ymax", y0 + bh)):
                        ET.SubElement(box, tag).text = str(v)
                ET.indent(ann)
                ET.ElementTree(ann).write(
                    os.path.join(year_root, "Annotations", stem + ".xml"))
                write_jpeg(os.path.join(year_root, "JPEGImages",
                                        stem + ".jpg"), img)
                stems.append(stem)
            with open(os.path.join(year_root, "ImageSets", "Main",
                                   split + ".txt"), "w") as f:
                f.write("".join(s + "\n" for s in stems))
    return devkit


def _fixture_polygon(rng: np.random.RandomState, cx: float, cy: float,
                     radius: float, concave: bool) -> np.ndarray:
    """A closed polygon of 8 (convex) or 10 (a star) vertices about (cx,
    cy), as ``[K, 2]`` floats rounded to 0.1 px."""
    k = 10 if concave else 8
    ang = np.sort(rng.uniform(0, 2 * np.pi, k)) if not concave else (
        np.arange(k) * 2 * np.pi / k + rng.uniform(0, 0.3))
    rad = radius * (np.where(np.arange(k) % 2, 0.45, 1.0) if concave
                    else rng.uniform(0.7, 1.0, k))
    pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
    return np.round(pts, 1)


def write_featuremap_fixture(root: str, hw=(480, 640), objects: int = 2,
                             seed: int = 0, image_id: int = 130566):
    """The feature-map study's input: a seeded single-image COCO json
    (``fixture.json``) and its PNG beside it, ``objects`` (1 or 2)
    polygon-segmented objects (a convex blob of COCO category 1, a star of
    category 3) filled with colour on gray noise.  Returns the json's
    path."""
    from ..data.coco_api import polygons_to_mask

    h, w = hw
    rng = np.random.RandomState(seed)
    img = rng.randint(90, 140, (h, w, 3)).astype(np.uint8)
    os.makedirs(root, exist_ok=True)
    name = f"{image_id:012}.png"
    annotations = []
    for i in range(objects):
        radius = min(h, w) * rng.uniform(0.15, 0.22)
        cx = w * (0.3 + 0.4 * i) + rng.uniform(-0.05, 0.05) * w
        cy = h * rng.uniform(0.35, 0.55)
        poly = _fixture_polygon(rng, cx, cy, radius, concave=i == 1)
        flat = [float(v) for v in poly.reshape(-1)]
        mask = polygons_to_mask([flat], h, w).astype(bool)
        img[mask] = rng.randint(0, 256, 3)
        x0, y0 = poly.min(0)
        x1, y1 = poly.max(0)
        annotations.append({
            "id": i + 1, "image_id": image_id, "category_id": (1, 3)[i],
            "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
            "area": float(mask.sum()), "iscrowd": 0,
            "segmentation": [flat]})
    write_png(os.path.join(root, name), img)
    path = os.path.join(root, "fixture.json")
    with open(path, "w") as f:
        json.dump({"images": [{"id": image_id, "width": w, "height": h,
                               "file_name": name}],
                   "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"},
                                  {"id": 3, "name": "car"}]}, f)
    return path


# published COCO ids (none retired) the polygon dataset draws from
POLYGON_CATEGORIES = (1, 3, 18, 44, 62)


def write_polygon_dataset(root: str, n: int, hw, objects: int = 3,
                          seed: int = 0, fmt: str = "jpeg"):
    """A seeded COCO json of polygon segmentations, the 24-point label
    generator's input: ``n`` images ``root/images/{id:012}.jpg`` of ``hw``
    (``fmt`` content, ``"jpeg"`` quality 95 4:2:0 by default), each with
    ``objects`` convex blobs and stars (:func:`_fixture_polygon`) of
    :data:`POLYGON_CATEGORIES` filled with colour on gray noise, and
    ``root/instances.json`` (``area`` the mask's pixel count).  Returns
    (image dir, json path)."""
    from ..data.coco_api import polygons_to_mask

    if fmt not in _WRITERS:
        raise ValueError(f"fmt {fmt!r}: one of {sorted(_WRITERS)}")
    h, w = hw
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for img_id in range(1, n + 1):
        img = rng.randint(90, 140, (h, w, 3)).astype(np.uint8)
        for _ in range(objects):
            radius = min(h, w) * rng.uniform(0.08, 0.2)
            cx, cy = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
            poly = _fixture_polygon(rng, cx, cy, radius,
                                    concave=bool(rng.randint(2)))
            flat = [float(v) for v in poly.reshape(-1)]
            mask = polygons_to_mask([flat], h, w).astype(bool)
            img[mask] = rng.randint(0, 256, 3)
            x0, y0 = np.clip(poly.min(0), 0, None)
            x1, y1 = np.minimum(poly.max(0), (w, h))
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id,
                "category_id": int(rng.choice(POLYGON_CATEGORIES)),
                "bbox": [float(x0), float(y0), float(x1 - x0),
                         float(y1 - y0)],
                "area": float(mask.sum()), "iscrowd": 0,
                "segmentation": [flat]})
        name = f"{img_id:012}.jpg"
        _WRITERS[fmt](os.path.join(img_dir, name), img)
        images.append({"id": img_id, "width": w, "height": h,
                       "file_name": name})
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": str(c)}
                                  for c in POLYGON_CATEGORIES]}, f)
    return img_dir, path


def label_detections(targets, max_det: int = 10):
    """Padded label rows ``[B, max_labels, 51]`` (``TrainTransform24P``'s)
    -> detection rows ``[B, max_det, 29]`` (cx, cy, 24 radii, score 0.9,
    class score 1, class) and their valid mask ``[B, max_det]``, numpy."""
    rows = np.zeros((len(targets), max_det, 29), np.float32)
    valid = np.zeros((len(targets), max_det), bool)
    for i, target in enumerate(targets):
        for k, row in enumerate(r for r in target if r.sum() != 0):
            cx, cy = row[1], row[2]
            rows[i, k, :2] = cx, cy
            rows[i, k, 2:26] = np.hypot(row[3::2] - cx, row[4::2] - cy)
            rows[i, k, 26:29] = 0.9, 1.0, row[0]
            valid[i, k] = True
    return rows, valid


def box_label_detections(records, max_det: int = 10):
    """Box annotations ``[N, 5]`` (x1, y1, x2, y2, cls) per image ->
    detection rows ``[B, max_det, 7]`` (the box, score 0.9, class score 1,
    class) and their valid mask ``[B, max_det]``, numpy."""
    rows = np.zeros((len(records), max_det, 7), np.float32)
    valid = np.zeros((len(records), max_det), bool)
    for i, rec in enumerate(records):
        n = min(len(rec), max_det)
        rows[i, :n, :4] = rec[:n, :4]
        rows[i, :n, 4:6] = 0.9, 1.0
        rows[i, :n, 6] = rec[:n, 4]
        valid[i, :n] = True
    return rows, valid


class LabelOracle:
    """``infer_fn`` whose detections are ``dataset``'s labels, in order, on
    ``device``: a 24p dataset's label rows, or a box dataset's annotations
    (one with ``load_anno``: COCO's, and VOC's with its difficult objects,
    which the VOC protocol neither counts nor penalises; they are in the
    letterboxed pixels at the evaluation size).  Pure in its input: a batch seen again (evaluators run
    their first batch twice) gets the same detections.  ``indices``: the
    dataset indices the loader visits, in order (a rank's strided share
    under distributed evaluation); every index by default."""

    def __init__(self, dataset, device, max_det: int = 10, indices=None):
        self.dataset, self.device, self.max_det = dataset, device, max_det
        self.order = (list(range(len(dataset))) if indices is None
                      else list(indices))
        self.next, self.cache = 0, {}

    def __call__(self, imgs):
        from ..eval.postprocess import Detections

        key = hash(np.asarray(imgs).tobytes())
        if key not in self.cache:
            index = self.order[self.next:self.next + len(imgs)]
            self.next += len(imgs)
            if hasattr(self.dataset, "load_anno"):
                rows, valid = box_label_detections(
                    [self.dataset.load_anno(i) for i in index], self.max_det)
            else:
                rows, valid = label_detections(
                    [self.dataset[i][1] for i in index], self.max_det)
            self.cache[key] = Detections(
                torch.from_numpy(rows).to(self.device),
                torch.from_numpy(valid).to(self.device))
        return self.cache[key]
