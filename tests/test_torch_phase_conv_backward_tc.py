"""Host-side layout decisions of the tensor-core backward of the port's
phase_conv, on the CPU: the weight packing both data gradients read, the
per-parity-class plan of the stride-2 data gradient, the weight gradient's M
tiling and split plan, and the variant predicates.  The kernels themselves
run only on the card (tests/test_torch_gpu.py)."""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu_torch.ops import phase_conv as pc

# the backward calls of the 24p-s training step at 640 px, batch 8:
# (k, stride, padding, H, W, C, Co); the stem takes no data gradient
MAIN_PATH = {
    "stem": (6, 2, 2, 640, 640, 3, 32),
    "dark2_conv": (3, 2, 1, 320, 320, 32, 64),
    "dark2_csp.conv1": (1, 1, 0, 160, 160, 64, 32),
    "dark2_csp.conv2": (1, 1, 0, 160, 160, 64, 32),
    "dark2_csp.m0.conv1": (1, 1, 0, 160, 160, 32, 32),
    "dark2_csp.m0.conv2": (3, 1, 1, 160, 160, 32, 32),
    "dark2_csp.conv3": (1, 1, 0, 160, 160, 64, 64),
    "dark3_conv": (3, 2, 1, 160, 160, 64, 128),
}
# shapes the tensor-core predicates leave to the CUDA-core kernels
RAGGED = {
    "odd_co": (3, 1, 1, 12, 20, 32, 33),
    "c48": (3, 2, 1, 16, 12, 48, 64),
    "narrow": (3, 1, 1, 8, 8, 4, 8),
    "k4": (4, 2, 1, 16, 16, 8, 16),
    "co130": (3, 1, 1, 5, 7, 70, 130),
    "stem_rows_not_16_bytes": (6, 2, 2, 12, 10, 3, 32),
}


def _inputs(shape, seed=0, batch=2):
    k, s, p, h, w, c, co = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, h, w, c).astype(np.float32)
    wgt = (rng.randn(k, k, c, co) * 0.1).astype(np.float32)
    ho, wo = pc.out_hw(h, w, k, s, p)
    dy = rng.randn(batch, ho, wo, co).astype(np.float32)
    return x, wgt, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [n for n, v in MAIN_PATH.items() if v[1] == 1])
def test_flipped_pack_is_pack_taps_of_flipped_weights(name, dtype):
    """What the packing kernel writes for a stride-1 data gradient is, byte
    for byte, the forward's packing of the flipped weights."""
    k, _, _, _, _, c, co = MAIN_PATH[name]
    w = torch.from_numpy(_inputs((k, 1, (k - 1) // 2, 4, 4, c, co), seed=3)[1])
    w = w.to(getattr(torch, dtype))
    got = pc.pack_taps_reference(w, pc.flip_taps(k))
    want = pc._pack_taps(pc.flipped_weights(w))
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype,digest", [
    ("float32",
     "69ecad38339464a7cd8bdb290aa01925b0b2dd171f3c9c9fd77424d712f51e98"),
    ("bfloat16",
     "8abc87344630d6c65ec8c6ed27bf2bd8f0c25afa00647c9ddbae91511fdad704"),
])
def test_flipped_pack_bytes_are_pinned(dtype, digest):
    """The bytes of ``_pack_taps(flipped_weights(w))`` for one seeded 3x3
    32->64 ``w``: the layout the packing kernel is held to on the card may
    not drift unnoticed."""
    w = torch.from_numpy(
        (np.random.RandomState(7).randn(3, 3, 32, 64) * 0.1).astype(np.float32))
    packed = pc._pack_taps(pc.flipped_weights(w.to(getattr(torch, dtype))))
    raw = packed.contiguous().view(torch.uint8).numpy().tobytes()
    assert hashlib.sha256(raw).hexdigest() == digest
    assert torch.equal(pc.pack_taps(w.to(getattr(torch, dtype)),
                                    pc.flip_taps(3)), packed)


def _unpack(packed, c, co):
    """Packed fp32 taps [n, Co/32, 2, C, 32] -> [n, Co, C] (hi + lo, the K
    order undone)."""
    n = packed.shape[0]
    inv = np.argsort(pc.K_ORDER["wgmma_taps"])
    both = packed.double()[..., inv]                 # [n, Co/32, 2, C, 32]
    w = both[:, :, 0] + both[:, :, 1]                # [n, Co/32, C, 32]
    return w.permute(0, 1, 3, 2).reshape(n, co, c)


def _dgrad_from_classes(dy, w, x_shape, padding):
    """The stride-2 data gradient as the class kernel computes it, from the
    packed class weights: for each class and tap, dx[class pixels] +=
    dy[class pixel + (oy, ox)] @ packed tap, dy read as zero outside."""
    k, _, c, co = w.shape
    b, h, wd, _ = x_shape
    plan = pc.dgrad_class_plan(k, padding)
    taps = [t for _, _, ts in plan for t in ts]
    wts = _unpack(pc.pack_taps_reference(w, [ky * k + kx for ky, kx, _, _ in
                                             taps]), c, co)
    dyd = dy.double()
    _, ho, wo, _ = dy.shape
    dx = torch.zeros(x_shape, dtype=torch.float64)
    j = 0
    for ph, pw, ts in plan:
        hc, wc = h // 2, wd // 2
        for _ in ts:
            _, _, oy, ox = taps[j]
            src = torch.zeros((b, hc, wc, co), dtype=torch.float64)
            y0, y1 = max(0, -oy), min(hc, ho - oy)
            x0, x1 = max(0, -ox), min(wc, wo - ox)
            if y1 > y0 and x1 > x0:
                src[:, y0:y1, x0:x1] = dyd[:, y0 + oy:y1 + oy, x0 + ox:x1 + ox]
            dx[:, ph::2, pw::2] += src @ wts[j]
            j += 1
    return dx.float()


@pytest.mark.parametrize("shape", [
    MAIN_PATH["dark2_conv"][:3] + (32, 32, 32, 64),
    MAIN_PATH["dark3_conv"][:3] + (16, 16, 64, 128),
    (3, 2, 1, 26, 38, 32, 32),
    (1, 2, 0, 8, 6, 32, 32),       # three classes without a tap
])
def test_class_packing_gives_the_data_gradient(shape):
    """The packed per-class weights, unpacked and applied with plain matmuls
    over shifted dy, give ``phase_conv_dgrad_reference`` and ``jax.vjp`` of
    ``lax.conv_general_dilated``: fp32, 1e-5 x scale."""
    k, s, p = shape[:3]
    x, wgt, dy = _inputs(shape, seed=11)
    got = _dgrad_from_classes(torch.from_numpy(dy), torch.from_numpy(wgt),
                              x.shape, p)
    ref = pc.phase_conv_dgrad_reference(torch.from_numpy(dy),
                                        torch.from_numpy(wgt), x.shape, s, p)

    def conv(x_, w_):
        return jax.lax.conv_general_dilated(
            x_, w_, window_strides=(s, s), padding=[(p, p), (p, p)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    _, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(wgt))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    for other in (ref.numpy(), want):
        tol = 1e-5 * max(1.0, np.abs(other).max())
        np.testing.assert_allclose(got.numpy(), other, atol=tol, rtol=0)


@pytest.mark.parametrize("k,padding", [(3, 1), (1, 0), (4, 1), (6, 2)])
def test_class_plan_takes_every_tap_once_at_its_pixel(k, padding):
    plan = pc.dgrad_class_plan(k, padding)
    assert sorted((ph, pw) for ph, pw, _ in plan) == [(0, 0), (0, 1), (1, 0),
                                                      (1, 1)]
    counts = [len(ts) for _, _, ts in plan]
    assert counts == sorted(counts, reverse=True)
    seen = []
    for ph, pw, ts in plan:
        for ky, kx, oy, ox in ts:
            # input pixel 2 h2 + ph is reached from output h2 + oy by tap ky
            assert 2 * oy + ky - padding == ph and 2 * ox + kx - padding == pw
            seen.append((ky, kx))
        assert [t[:2] for t in ts] == sorted(t[:2] for t in ts)
    assert sorted(seen) == [(ky, kx) for ky in range(k) for kx in range(k)]


# the ragged shapes whose weight gradient the tensor cores take: C and Co
# multiples of 8 (C = 4: flat rows); the others stay on the CUDA cores
RAGGED_WGRAD = {"c48": "wgmma", "narrow": "wgmma", "k4": "wgmma"}
# the ragged shape whose data gradient the tensor cores take: k 1 or 3, C
# and Co multiples of 8; the other four (odd Co, C = 4, k = 4, C = 70) and
# the stem stay on the CUDA cores
RAGGED_DGRAD = {"c48": "wgmma_classes"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variants_of_the_main_path_and_ragged_shapes(dtype):
    """All 8 weight gradients and 7 data gradients of the main path take a
    tensor-core variant; the ragged shapes the CUDA-core kernels, but for
    the weight gradients of ``RAGGED_WGRAD`` and the data gradients of
    ``RAGGED_DGRAD``."""
    for name, (k, s, p, h, w, c, co) in MAIN_PATH.items():
        ho, wo = pc.out_hw(h, w, k, s, p)
        assert pc.wgrad_variant((8, h, w, c), co, k, s, dtype) == "wgmma", name
        if name != "stem":
            want = "flipped:wgmma_taps" if s == 1 else "wgmma_classes"
            assert pc.dgrad_variant((8, ho, wo, co), (k, k, c, co), s, p,
                                    dtype) == want, name
    for name, (k, s, p, h, w, c, co) in RAGGED.items():
        ho, wo = pc.out_hw(h, w, k, s, p)
        assert pc.wgrad_variant((3, h, w, c), co, k, s, dtype) == \
            RAGGED_WGRAD.get(name, "cuda_cores"), name
        assert pc.dgrad_variant((3, ho, wo, co), (k, k, c, co), s, p,
                                dtype) == RAGGED_DGRAD.get(name,
                                                           "cuda_cores"), name


def test_wgrad_tiles_of_the_main_path():
    """M tiles of whole ky values, 64 dw rows a warpgroup: the stem's 108
    rows in one tile of flat rows, the others one ky a tile."""
    f32 = torch.float32
    want = {"stem": (6, 2, True), "dark2_conv": (1, 2, False),
            "dark2_csp.conv1": (1, 1, False), "dark2_csp.conv2": (1, 1, False),
            "dark2_csp.m0.conv1": (1, 1, False),
            "dark2_csp.m0.conv2": (1, 2, False),
            "dark2_csp.conv3": (1, 1, False), "dark3_conv": (1, 3, False)}
    for name, (k, s, _, h, w, c, co) in MAIN_PATH.items():
        tiles = pc.wgrad_tiles((32, h, w, c), co, k, s, f32)
        assert tiles == want[name], name
        nky, wgs, _ = tiles
        assert k % nky == 0 and nky * k * c <= 64 * wgs < nky * k * c + 64


@pytest.mark.parametrize("chunks,mtiles,sms,wgs", [
    (32 * 320 * 10, 1, 132, 2), (32 * 80 * 3, 3, 132, 3),
    (32 * 160 * 5, 1, 132, 1), (1, 1, 132, 1), (7, 6, 132, 2),
    (2 * 13 * 1, 9, 4, 3), (1000, 2, 1, 2), (131, 1, 66, 1),
])
def test_wgrad_split_plan_covers_every_chunk_once(chunks, mtiles, sms, wgs):
    splits, per = pc.wgrad_split_plan(chunks, mtiles, sms, wgs)
    assert splits >= 1 and per >= 1
    covered = np.zeros(chunks, np.int64)
    for i in range(splits):
        lo, hi = i * per, min((i + 1) * per, chunks)
        assert hi > lo, "every split sums at least one chunk"
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("shape", [
    (6, 2, 2, 16, 24, 3, 32),
    (3, 2, 1, 26, 38, 32, 32),
    (1, 1, 0, 13, 27, 96, 128),
    (3, 1, 1, 10, 70, 64, 64),
])
def test_wgrad_tiling_and_chunks_give_the_weight_gradient(shape):
    """The tensor-core weight gradient's decomposition emulated on the host:
    M tiles of whole ky values, splits over chunks of 32 output pixels along
    one output row, input segments from ``s * wo0 - p`` read at
    ``s * j + kx``, read as zero outside x; the partial sums added in split
    order equal ``phase_conv_wgrad_reference`` (fp32, 1e-5 x scale)."""
    k, s, p, h, w, c, co = shape
    x, _, dy = _inputs(shape, seed=5)
    b, (ho, wo) = x.shape[0], pc.out_hw(h, w, k, s, p)
    nky, wgs, _ = pc.wgrad_tiles(x.shape, co, k, s, torch.float32)
    chunk = pc.WGRAD_CHUNK
    cpr = -(-wo // chunk)
    chunks = b * ho * cpr
    splits, per = pc.wgrad_split_plan(chunks, k // nky, 8, wgs)
    xp = np.zeros((b, h + 2 * p + k, w + 2 * p + s * chunk + k, c))
    xp[:, p:p + h, p:p + w] = x            # x[iy, ix] at xp[iy + p, ix + p]
    dyp = np.zeros((b, ho, cpr * chunk, co))
    dyp[:, :, :wo] = dy
    rows = nky * k * c
    dw = np.zeros((k * k * c, co))
    for m in range(k // nky):
        part = np.zeros((splits, rows, co))
        r = np.arange(rows)
        ky = m * nky + r // (k * c)
        kx = (r % (k * c)) // c
        ch = r % c
        for sp in range(splits):
            for cid in range(sp * per, min((sp + 1) * per, chunks)):
                row, wo0 = cid // cpr, (cid % cpr) * chunk
                bb, oy = row // ho, row % ho
                j = np.arange(chunk)
                iy = s * oy - p + ky                            # [rows]
                ix = s * wo0 - p + s * j[None, :] + kx[:, None]  # [rows, 32]
                a = xp[bb, iy[:, None] + p, ix + p, ch[:, None]]
                part[sp] += a @ dyp[bb, oy, wo0:wo0 + chunk]
        dw[m * rows:(m + 1) * rows] = part.sum(axis=0)
    want = pc.phase_conv_wgrad_reference(torch.from_numpy(x),
                                         torch.from_numpy(dy), k, s, p)
    want = want.numpy().reshape(k * k * c, co)
    np.testing.assert_allclose(dw, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
