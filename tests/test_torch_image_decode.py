"""The port's JPEG and PNG decoders (``csrc/image_decode.cpp`` through
``data/image_io.py``) against OpenCV, whose ``cv2.imread`` / ``cv2.imdecode``
decode with libjpeg-turbo and libpng; the port's numpy encoders
(``utils/synth.py``) decoded by both; the pinned digests ``chip_smoke.py``
checks on the card; and the 24p dataset read from JPEG files against
``eop_tpu``'s.

Tolerances: every supported JPEG mode and every PNG case bit-equal to cv2
with cv2 blocked for the port's decode; dataset images within the one level
of the port's resize (``resize_host``), labels bit-equal."""

import hashlib
import io
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
from eop_tpu.data.coco24p import COCO24PDataset as JDataset  # noqa: E402
from eop_tpu.data.coco24p import TrainTransform24P as JTransform  # noqa: E402
from eop_tpu_torch.data import image_io  # noqa: E402
from eop_tpu_torch.data.coco24p import (  # noqa: E402
    COCO24PDataset,
    TrainTransform24P,
)
from eop_tpu_torch.data.image_io import (  # noqa: E402
    UnsupportedImageError,
    image_size,
    imdecode,
    imread,
)
from eop_tpu_torch.utils import synth  # noqa: E402

SAMPLING = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = [(1, 1), (2, 40), (8, 8), (16, 16), (17, 33), (33, 17), (71, 129)]


@pytest.fixture
def no_cv2(monkeypatch):
    """``import cv2`` raises from here on: the port decodes alone."""
    monkeypatch.setitem(sys.modules, "cv2", None)


def make_image(hw, seed):
    """Noise over smooth ramps: flat and busy blocks, full-range values."""
    h, w = hw
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    ramps = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                      (xx + yy) * 3 % 256], -1)
    noise = rng.randint(0, 256, (h, w, 3))
    return np.where(rng.rand(h, w, 1) < 0.3, noise, ramps).astype(np.uint8)


def assert_decodes_as_cv2(tmp_path, data: bytes, monkeypatch):
    """imread, imdecode and image_size of ``data`` equal cv2's, with cv2
    blocked while the port decodes."""
    path = str(tmp_path / "000000000001.jpg")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path)
    assert want is not None
    want_buf = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(want, want_buf)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        got = imread(path)
        got_buf = imdecode(data)
        size = image_size(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_buf, want)
    assert size == (want.shape[1], want.shape[0])


# ---------------------------------------------------------------------------
# JPEG


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("quality", [10, 50, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_jpeg_bit_equal_to_cv2(tmp_path, monkeypatch, hw, quality, sampling):
    """Sizes that are and are not multiples of 8 and 16 (partial MCUs, odd
    chroma widths), every luma sampling, IJG quality scaling from 10 (OpenCV
    caps its quantizers at 255 then) to 100."""
    img = make_image(hw, hw[0] * 131 + hw[1] + quality)
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert ok
    assert_decodes_as_cv2(tmp_path, buf.tobytes(), monkeypatch)


def _dqt_16bit(data: bytes, factor: int) -> bytes:
    """``data`` with every quantization table rewritten with 16-bit entries
    scaled by ``factor`` (OpenCV's encoder forces baseline 8-bit tables, so
    the 16-bit DQT path needs a file made by hand)."""
    out, at = bytearray(), 0
    while (seg := data.find(b"\xff\xdb", at)) >= 0:
        length = int.from_bytes(data[seg + 2:seg + 4], "big")
        body, tables = data[seg + 4:seg + 2 + length], b""
        while body:
            pq, tq = body[0] >> 4, body[0] & 15
            n = 64 * (pq + 1)
            vals = np.frombuffer(body[1:1 + n], ">u2" if pq else np.uint8)
            tables += bytes([0x10 | tq]) + (vals.astype(np.int64) * factor) \
                .astype(">u2").tobytes()
            body = body[1 + n:]
        out += data[at:seg] + b"\xff\xdb" + (len(tables) + 2).to_bytes(
            2, "big") + tables
        at = seg + 2 + length
    return bytes(out + data[at:])


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:0"])
@pytest.mark.parametrize("quality,factor", [(75, 1), (100, 256)])
def test_16_bit_quantization_tables_bit_equal_to_cv2(
        tmp_path, monkeypatch, sampling, quality, factor):
    """16-bit DQT entries: equal to the file's 8-bit ones (the same image as
    the original file), and 256 (all-ones tables of quality 100 scaled) over
    a nearly flat image, whose dequantized coefficients stay in the 16 bits
    libjpeg-turbo's SIMD IDCT computes them in."""
    rng = np.random.RandomState(quality)
    img = make_image((24, 40), quality) if factor == 1 else (
        128 + rng.randint(-1, 2, (24, 40, 3))).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    data = _dqt_16bit(buf.tobytes(), factor)
    at = data.index(b"\xff\xdb")
    assert data[at + 4] >> 4 == 1  # Pq = 1: 16-bit entries
    if factor == 1:
        np.testing.assert_array_equal(imdecode(data), imdecode(buf.tobytes()))
    assert_decodes_as_cv2(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("hw", [(1, 1), (17, 33), (64, 96)])
def test_gray_jpeg_bit_equal_to_cv2(tmp_path, monkeypatch, hw):
    gray = make_image(hw, 3)[..., 1]
    ok, buf = cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert_decodes_as_cv2(tmp_path, buf.tobytes(), monkeypatch)


@pytest.mark.parametrize("interval", [1, 2, 3, 7, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_restart_intervals_bit_equal_to_cv2(tmp_path, monkeypatch, interval,
                                             sampling):
    """Restart intervals that do and do not divide the MCU count."""
    img = make_image((37, 53), interval)
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert b"\xff\xdd" in buf.tobytes()
    assert_decodes_as_cv2(tmp_path, buf.tobytes(), monkeypatch)


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(tmp_path, monkeypatch, fmt, orientation):
    """EXIF orientations written with PIL (JPEG APP1, PNG eXIf): cv2.imread
    turns the image, and image_size swaps w and h for 5-8."""
    pil = pytest.importorskip("PIL.Image")
    exif = pil.Exif()
    exif[0x0112] = orientation
    out = io.BytesIO()
    pil.fromarray(make_image((13, 22), orientation)).save(
        out, format=fmt, exif=exif.tobytes())
    assert_decodes_as_cv2(tmp_path, out.getvalue(), monkeypatch)


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_image_size_reads_headers_past_its_head(tmp_path, monkeypatch, fmt):
    """image_size reads the first 64 KiB of a file, and all of it where the
    header runs past them: here 80 KB of comments before the EXIF
    orientation (JPEG COM segments, a PNG tEXt chunk)."""
    pil = pytest.importorskip("PIL.Image")
    exif = pil.Exif()
    exif[0x0112] = 6
    out = io.BytesIO()
    pil.fromarray(make_image((13, 22), 6)).save(out, format=fmt,
                                                exif=exif.tobytes())
    data = out.getvalue()
    if fmt == "JPEG":
        com = b"\xff\xfe" + (40002).to_bytes(2, "big") + b"c" * 40000
        data = data[:2] + 2 * com + data[2:]
    else:  # after the 8-byte signature and the 25-byte IHDR chunk
        data = data[:33] + png_chunk(b"tEXt", b"k\x00" + b"c" * 80000) \
            + data[33:]
    assert len(data) > image_io._HEAD_BYTES
    assert_decodes_as_cv2(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("kind", ["jpeg", "png", "bmp"])
def test_image_size_reads_only_the_head_of_a_file(tmp_path, monkeypatch,
                                                  kind):
    """Evaluator24P asks image_size for every image: it reads the first 64
    KiB of a 360x640 file, not all of it."""
    img = make_image((360, 640), 5)
    path = tmp_path / f"a.{kind}"
    if kind == "bmp":
        synth.write_bmp(str(path), img)
    else:
        path.write_bytes(synth.encode_jpeg(img) if kind == "jpeg"
                         else synth.encode_png(img))
    assert path.stat().st_size > image_io._HEAD_BYTES
    reads = []

    class Counted(io.BytesIO):
        def read(self, n=-1):
            out = super().read(n)
            reads.append(len(out))
            return out

    monkeypatch.setattr(image_io, "open", lambda p, mode: Counted(
        open(p, mode).read()), raising=False)
    assert image_size(str(path)) == (640, 360)
    assert sum(reads) <= image_io._HEAD_BYTES


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_optimized_huffman_tables_bit_equal_to_cv2(tmp_path, monkeypatch,
                                                    subsampling):
    """PIL's encoder with per-image Huffman tables (``optimize``)."""
    pil = pytest.importorskip("PIL.Image")
    out = io.BytesIO()
    pil.fromarray(make_image((45, 67), subsampling)).save(
        out, format="JPEG", quality=80, subsampling=subsampling,
        optimize=True)
    assert_decodes_as_cv2(tmp_path, out.getvalue(), monkeypatch)


def test_rgb_jpeg_bit_equal_to_cv2(tmp_path, monkeypatch):
    """A JPEG that stores RGB, not YCbCr (Adobe marker, transform 0): the
    colour space libjpeg guesses from the markers."""
    pil = pytest.importorskip("PIL.Image")
    out = io.BytesIO()
    pil.fromarray(make_image((21, 34), 9)).save(out, format="JPEG",
                                                 keep_rgb=True)
    data = out.getvalue()
    assert b"Adobe" in data
    assert_decodes_as_cv2(tmp_path, data, monkeypatch)


def _sof_patched(data: bytes, marker: int = None, precision: int = None):
    """A baseline JPEG with its SOF0 marker or precision byte changed: a
    file that declares another coding process."""
    buf = bytearray(data)
    at = buf.index(b"\xff\xc0")
    if marker is not None:
        buf[at + 1] = marker
    if precision is not None:
        buf[at + 4] = precision
    return bytes(buf)


def _progressive():
    ok, buf = cv2.imencode(".jpg", make_image((24, 40), 1),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    return buf.tobytes()


def _baseline():
    ok, buf = cv2.imencode(".jpg", make_image((24, 40), 1))
    return buf.tobytes()


def _cmyk():
    pil = pytest.importorskip("PIL.Image")
    out = io.BytesIO()
    pil.fromarray(make_image((24, 40), 2)).convert("CMYK").save(
        out, format="JPEG")
    return out.getvalue()


@pytest.mark.parametrize("make,name", [
    (_progressive, "progressive JPEG"),
    (lambda: _sof_patched(_baseline(), marker=0xC9), "arithmetic-coded JPEG"),
    (lambda: _sof_patched(_baseline(), marker=0xC3), "lossless JPEG"),
    (lambda: _sof_patched(_baseline(), precision=12),
     "sample precision other than 8"),
    (_cmyk, "CMYK"),
])
def test_unsupported_jpeg_raises_naming_itself_without_cv2(tmp_path, no_cv2,
                                                           make, name):
    data = make()
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(UnsupportedImageError, match=name):
        imread(path)
    with pytest.raises(UnsupportedImageError, match=f"{name}.*needs OpenCV"):
        imdecode(data)
    # the size comes from the header, which the port reads for any frame
    assert image_size(path) == (40, 24)


def test_progressive_jpeg_goes_to_cv2_where_installed(tmp_path):
    data = _progressive()
    np.testing.assert_array_equal(
        imdecode(data), cv2.imdecode(np.frombuffer(data, np.uint8), 1))


def test_truncated_jpeg_raises_where_libjpeg_pads(no_cv2):
    """libjpeg decodes truncated entropy data as zeros and warns; the port
    raises."""
    data = _baseline()
    with pytest.raises(ValueError, match="truncated JPEG data"):
        imdecode(data[:len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        imdecode(data[:len(data) // 2] + b"\xff\xd9")


@pytest.mark.parametrize("kind", ["jpeg", "png"])
def test_corrupted_bytes_decode_or_raise(no_cv2, kind):
    """Bytes overwritten, cut out and inserted at random (HTTP bodies come
    from outside): every mutant decodes or raises ValueError /
    UnsupportedImageError, never crashes the process."""
    img = make_image((23, 37), 4)
    seed = synth.encode_jpeg(img) if kind == "jpeg" else synth.encode_png(img)
    rng = np.random.RandomState(0)
    outcomes = set()
    for _ in range(300):
        data = bytearray(seed)
        for _ in range(rng.randint(1, 6)):
            at = rng.randint(len(data))
            op = rng.randint(3)
            if op == 0:
                data[at] = rng.randint(256)
            elif op == 1:
                del data[at:at + rng.randint(1, 40)]
            else:
                data[at:at] = rng.bytes(rng.randint(1, 20))
        try:
            imdecode(bytes(data))
            outcomes.add("decoded")
        except (ValueError, UnsupportedImageError) as e:
            outcomes.add(type(e).__name__)
    assert "ValueError" in outcomes


# ---------------------------------------------------------------------------
# PNG

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return (len(body).to_bytes(4, "big") + kind + body
            + zlib.crc32(kind + body).to_bytes(4, "big"))


def _packed_rows(samples, depth):
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth >= 8:
        return [r.astype(">u2" if depth == 16 else np.uint8).tobytes()
                for r in flat]
    per = 8 // depth
    shifts = 8 - depth * (np.arange(per) + 1)
    rows = []
    for r in flat:
        r = np.concatenate([r, np.zeros((-len(r)) % per, int)])
        rows.append((r.reshape(-1, per) << shifts).sum(1).astype(
            np.uint8).tobytes())
    return rows


def _filtered(rows, bpp, rng):
    """Rows, each with a random one of the five filter types."""
    out, prev = [], np.zeros(len(rows[0]), np.int32)
    for r in rows:
        x = np.frombuffer(r, np.uint8).astype(np.int32)
        shift = lambda v: np.concatenate([np.zeros(bpp, np.int32),  # noqa
                                          v[:-bpp]])[:len(v)]
        left, upleft = shift(x), shift(prev)
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        kind = rng.randint(0, 5)
        pred = [0, left, prev, (left + prev) // 2, paeth][kind]
        out.append(bytes([kind])
                   + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


def encode_png_samples(samples, color, depth, interlace, palette=None,
                       extra=b"", seed=0):
    """A PNG of any colour type, bit depth and interlace from its samples
    ``[h, w, channels]`` (the IDAT stream split over two chunks)."""
    h, w = samples.shape[:2]
    rng = np.random.RandomState(seed)
    bpp = max(1, CHANNELS[color] * depth // 8)
    if interlace:
        data = b"".join(
            _filtered(_packed_rows(sub, depth), bpp, rng)
            for sub in (samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7)
            if sub.size)
    else:
        data = _filtered(_packed_rows(samples, depth), bpp, rng)
    z = zlib.compress(data)
    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([depth, color, 0, 0, interlace]))
    return (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", ihdr)
            + (png_chunk(b"PLTE", palette) if palette is not None else b"")
            + extra + png_chunk(b"IDAT", z[:len(z) // 2])
            + png_chunk(b"IDAT", z[len(z) // 2:]) + png_chunk(b"IEND", b""))


PNG_CASES = [(c, d, i) for c, depths in {
    0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
    6: (8, 16)}.items() for d in depths for i in (0, 1)]


@pytest.mark.parametrize("color,depth,interlace", PNG_CASES)
def test_png_bit_equal_to_cv2(tmp_path, monkeypatch, color, depth,
                              interlace):
    """Every colour type x bit depth x interlace, at sizes smaller than an
    Adam7 tile and ragged ones: alpha dropped, gray replicated, 16-bit
    samples as OpenCV maps them, 1/2/4-bit gray scaled."""
    for hw in [(1, 1), (5, 3), (17, 33)]:
        rng = np.random.RandomState(color * 100 + depth * 10 + interlace)
        top = min(1 << depth, 7) if color == 3 else 1 << depth
        samples = rng.randint(0, top, (*hw, CHANNELS[color]))
        palette = (rng.randint(0, 256, 21).astype(np.uint8).tobytes()
                   if color == 3 else None)
        data = encode_png_samples(samples, color, depth, interlace, palette,
                                  seed=hw[1])
        assert_decodes_as_cv2(tmp_path, data, monkeypatch)


def test_png_sixteen_bit_samples_keep_their_high_byte(no_cv2):
    """OpenCV strips 16-bit samples to their high byte (not 255/65535
    scaling): pinned without cv2."""
    samples = np.array([[[0x12ff, 0x8000, 0xfe01]]])
    got = imdecode(encode_png_samples(samples, 2, 16, 0))
    assert got[0, 0].tolist() == [0xfe, 0x80, 0x12]


@pytest.mark.parametrize("color", [0, 2, 3])
def test_png_transparency_is_ignored_as_cv2(tmp_path, monkeypatch, color):
    rng = np.random.RandomState(color)
    samples = rng.randint(0, 7 if color == 3 else 256,
                          (6, 7, CHANNELS[color]))
    palette = rng.randint(0, 256, 21).astype(np.uint8).tobytes() \
        if color == 3 else None
    trns = {0: b"\x00\x05", 2: b"\x00\x10\x00\x20\x00\x30", 3: b"\x00\x80"}
    data = encode_png_samples(samples, color, 8, 0, palette,
                              extra=png_chunk(b"tRNS", trns[color]))
    assert_decodes_as_cv2(tmp_path, data, monkeypatch)


@pytest.mark.parametrize("interlace", [0, 1])
def test_png_rows_past_the_header_are_ignored_as_libpng(tmp_path, monkeypatch,
                                                        interlace):
    """An IDAT stream that inflates past the rows the IHDR declares (4 MiB
    more here): libpng decodes the declared rows and warns, the port
    inflates only those."""
    samples = np.random.RandomState(interlace).randint(0, 256, (5, 3, 3))
    data = encode_png_samples(samples, 2, 8, interlace)
    rows = zlib.decompress(image_io._png_chunks(data, False)[2])
    idat = zlib.compress(rows + bytes(4 << 20), 9)
    bomb = (data[:33] + png_chunk(b"IDAT", idat) + png_chunk(b"IEND", b""))
    assert_decodes_as_cv2(tmp_path, bomb, monkeypatch)
    np.testing.assert_array_equal(imdecode(bomb), imdecode(data))


def test_png_crc_errors(no_cv2):
    """A CRC error in a critical chunk raises (cv2: None); in an ancillary
    one the chunk is skipped, as libpng does."""
    samples = np.random.RandomState(0).randint(0, 256, (6, 7, 3))
    data = bytearray(encode_png_samples(
        samples, 2, 8, 0, extra=png_chunk(b"tEXt", b"k\x00v")))
    good = imdecode(bytes(data))
    text = data.index(b"tEXt")
    data[text + 4] ^= 1
    np.testing.assert_array_equal(imdecode(bytes(data)), good)
    idat = data.index(b"IDAT")
    data[idat + 6] ^= 1
    with pytest.raises(ValueError, match="CRC error in its b'IDAT'"):
        imdecode(bytes(data))


# ---------------------------------------------------------------------------
# the port's encoders, the smoke's digests, the dataset


@pytest.mark.parametrize("hw", [(1, 1), (17, 33), (90, 160)])
@pytest.mark.parametrize("kind", ["jpeg 4:2:0", "jpeg 4:4:4", "png"])
def test_port_encoders_decode_equal_in_cv2_and_the_port(tmp_path, monkeypatch,
                                                        hw, kind):
    img = make_image(hw, 11)
    if kind == "png":
        data = synth.encode_png(img)
    else:
        data = synth.encode_jpeg(img, 95, kind.split()[1])
    assert_decodes_as_cv2(tmp_path, data, monkeypatch)
    got = imdecode(data)
    if kind == "png":
        np.testing.assert_array_equal(got, img)       # lossless
    elif kind == "jpeg 4:4:4":
        # libjpeg's colour conversion, DCT and quantization: what cv2's
        # own encoder writes at these settings, to the byte
        ok, buf = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, 95,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["4:4:4"]])
        np.testing.assert_array_equal(got, cv2.imdecode(buf, 1))


def test_encoder_tables_are_the_ones_libjpeg_writes():
    """Annex K Huffman tables and IJG's quality scaling, as found in what
    cv2 writes (quality 50 gives the base quantization tables)."""
    ok, buf = cv2.imencode(".jpg", make_image((8, 8), 0),
                           [cv2.IMWRITE_JPEG_QUALITY, 50])
    data = buf.tobytes()
    tables, quant = {}, {}
    for marker in (b"\xff\xc4", b"\xff\xdb"):
        at = 0
        while (at := data.find(marker, at)) >= 0:
            length = int.from_bytes(data[at + 2:at + 4], "big")
            body = data[at + 4:at + 2 + length]
            at += 2 + length
            while body:
                if marker == b"\xff\xc4":
                    counts = tuple(body[1:17])
                    tables[body[0]] = (counts,
                                       bytes(body[17:17 + sum(counts)]))
                    body = body[17 + sum(counts):]
                else:
                    zz = np.frombuffer(body[1:65], np.uint8)
                    natural = np.zeros(64, int)
                    natural[synth._ZIGZAG] = zz
                    quant[body[0] & 15] = natural
                    body = body[65:]
    ours = {0x00: synth._HUFF_DC_LUMA, 0x01: synth._HUFF_DC_CHROMA,
            0x10: synth._HUFF_AC_LUMA, 0x11: synth._HUFF_AC_CHROMA}
    for key, (counts, symbols) in ours.items():
        assert tables[key] == (tuple(counts), bytes(symbols)), hex(key)
    np.testing.assert_array_equal(quant[0], synth._QUANT_LUMA)
    np.testing.assert_array_equal(quant[1], synth._QUANT_CHROMA)
    np.testing.assert_array_equal(
        synth._quant_table(synth._QUANT_LUMA, 95),
        np.clip((synth._QUANT_LUMA * 10 + 50) // 100, 1, 255))


def test_pinned_digests_of_the_smoke_images(monkeypatch):
    """The seeded 720x1280 images ``chip_smoke.py``'s decode phase writes
    and decodes on the card: the encoded JPEGs' and every decoded array's
    sha256 are pinned there; cv2 gives the same bytes here, so the card's
    build is held to cv2 through them."""
    digests = chip_smoke.DECODE_DIGESTS
    inputs = chip_smoke.decode_inputs()
    got = {}
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        for kind, data in inputs.items():
            img = imdecode(data)
            assert img.shape == (720, 1280, 3)
            got[kind] = hashlib.sha256(img.tobytes()).hexdigest()
            if kind.startswith("jpeg"):
                assert hashlib.sha256(data).hexdigest() == \
                    digests[f"{kind} file"], kind
    assert got == {k: v for k, v in digests.items() if "file" not in k}
    for kind, data in inputs.items():
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert hashlib.sha256(img.tobytes()).hexdigest() == got[kind], kind


def test_dataset_items_from_jpeg_files_match_jax(tmp_path):
    """``COCO24PDataset`` over genuine JPEG files: eop_tpu reads them with
    cv2.imread, the port with its decoder; labels bit-equal, images within
    the resize's one level."""
    img_dir, lab_dir = synth.write_24p_dataset(str(tmp_path), 4, (90, 160),
                                               fmt="jpeg")
    with open(f"{img_dir}/000000000000.jpg", "rb") as f:
        assert f.read(2) == b"\xff\xd8"
    ds = COCO24PDataset(img_dir, lab_dir, (64, 64), TrainTransform24P(50))
    jds = JDataset(img_dir, lab_dir, (64, 64), JTransform(50))
    for i in range(len(ds)):
        img, labels, info, ids = ds[i]
        j_img, j_labels, j_info, j_ids = jds[i]
        assert np.abs(img - j_img).max() <= 1.0
        np.testing.assert_array_equal(labels, j_labels)
        assert tuple(info) == tuple(j_info) == (90, 160)
        np.testing.assert_array_equal(ids, j_ids)


@pytest.mark.parametrize("fmt", ["bmp", "jpeg", "png"])
def test_write_24p_dataset_formats_share_images_and_labels(tmp_path, fmt):
    """One seed, one set of images and labels, whatever the container; the
    default stays BMP."""
    img_dir, lab_dir = synth.write_24p_dataset(str(tmp_path / fmt), 2,
                                               (40, 56), seed=3, fmt=fmt)
    ref_dir, ref_lab = synth.write_24p_dataset(str(tmp_path / "default"), 2,
                                               (40, 56), seed=3)
    for i in range(2):
        name = f"{i:012}"
        got, ref = imread(f"{img_dir}/{name}.jpg"), imread(
            f"{ref_dir}/{name}.jpg")
        if fmt == "jpeg":
            np.testing.assert_array_equal(
                got, imdecode(synth.encode_jpeg(ref)))
        else:
            np.testing.assert_array_equal(got, ref)
        with open(f"{lab_dir}/{name}.txt") as a, \
                open(f"{ref_lab}/{name}.txt") as b:
            assert a.read() == b.read()
    with pytest.raises(ValueError, match="fmt 'gif'"):
        synth.write_24p_dataset(str(tmp_path / "gif"), 1, (8, 8), fmt="gif")


def test_decoder_is_one_library_loaded_once():
    """Workers load the built file: ``load_decoder`` builds or finds it, and
    the loaded library is cached per process."""
    from eop_tpu_torch import _build

    image_io.load_decoder()
    assert _build.load("image_decode") is _build.load("image_decode")
    assert _build.is_host("image_decode")
