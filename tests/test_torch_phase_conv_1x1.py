"""The port's ``small_1x1`` variant of phase_conv on the CPU: YOLOX-Nano's
16- and 32-channel 1x1 convs, forward and data gradient, whose CUDA kernel
(eop_tpu_torch/csrc/phase_conv_1x1.cu) runs only on the card
(tests/test_torch_gpu.py).  Here: the plain versions the kernel is held to
against the JAX Pallas kernel in interpret mode and ``jax.vjp``, which
convs take the variant, the kernel's tile walk and shared memory emulated
on the host, and the stems' weights in N tiles (``wgmma_rows`` at YOLOX-X's
800 px)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from eop_tpu.ops.pallas import conv_small_c as jax_pc
from eop_tpu_torch.ops import phase_conv as pc

DTYPES = ["float32", "bfloat16"]
# csrc/phase_conv_1x1.cu's plan, read from its source: threads of a block,
# pixels of a tile, ring stages
_SRC = (Path(pc.__file__).resolve().parents[1] / "csrc"
        / "phase_conv_1x1.cu").read_text()
THREADS, TILE, STAGES = (
    int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))
    for name in ("kThreads", "kTileM", "kStages"))
# YOLOX-Nano's five small 1x1 convs: (C, Co)
NANO_1X1 = {
    "dark2.0.pconv": (16, 32),
    "dark2.1.conv1": (32, 16),
    "dark2.1.conv2": (32, 16),
    "dark2.1.m.0.conv1": (16, 16),
    "dark2.1.m.0.conv2.pconv": (16, 16),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, co, seed, batch=2, h=13, w=11):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, h, w, c).astype(np.float32)
    wgt = (rng.randn(1, 1, c, co) / np.sqrt(c)).astype(np.float32)
    dy = rng.randn(batch, h, w, co).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, co).astype(np.float32)
    shift = rng.uniform(-1.0, 1.0, co).astype(np.float32)
    return x, wgt, dy, scale, shift


def _assert_scaled(got, want, tol):
    want = np.asarray(want, np.float32)
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(np.asarray(got, np.float32) - want).max()) <= bound


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("conv", list(NANO_1X1))
def test_plain_1x1_matches_jax_pallas_kernel(conv, dtype, epilogue):
    """The plain forward (what ``small_1x1`` is held to on the card)
    against the Pallas kernel in interpret mode, then scale, shift and
    SiLU: fp32 within 1e-5, bf16 within 1e-2 of the output's scale (one
    bf16 rounding, taken before the epilogue on the JAX side)."""
    c, co = NANO_1X1[conv]
    x, wgt, _, scale, shift = _inputs(c, co, seed=c + co)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_pc.phase_conv(jnp.asarray(x, jdt), jnp.asarray(wgt, jdt),
                                 stride=1, padding=0)
    kwargs = {}
    if epilogue:
        want = jax.nn.silu(want.astype(jnp.float32) * scale + shift)
        kwargs = dict(scale=torch.from_numpy(scale),
                      shift=torch.from_numpy(shift), act="silu")
    got = pc.phase_conv(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(wgt).to(tdt), 1, 0, **kwargs)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    _assert_scaled(got.float().numpy(), want,
                   1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("conv", list(NANO_1X1))
def test_plain_1x1_data_gradient_matches_jax(conv, dtype):
    """The plain data gradient (what ``small_1x1`` with the weights read
    transposed is held to) against ``jax.vjp`` of ``lax.conv_general_dilated``
    (the Pallas call has no reverse-mode rule; the JAX ``phase_conv`` equals
    that conv, tests/test_pallas_conv.py) and against the Pallas kernel on
    dy with the transposed weights, the 1x1 stride-1 data gradient's own
    form: fp32 within 1e-5, bf16 within 1e-2 of the scale."""
    c, co = NANO_1X1[conv]
    x, wgt, dy, _, _ = _inputs(c, co, seed=3 * c + co)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def conv_fn(x_):
        return jax.lax.conv_general_dilated(
            x_, jnp.asarray(wgt, jdt), window_strides=(1, 1),
            padding=[(0, 0), (0, 0)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    _, vjp = jax.vjp(conv_fn, jnp.asarray(x, jdt))
    (want_vjp,) = vjp(jnp.asarray(dy, jdt))
    with pltpu.force_tpu_interpret_mode():
        want_kernel = jax_pc.phase_conv(
            jnp.asarray(dy, jdt),
            jnp.asarray(wgt.transpose(0, 1, 3, 2), jdt), stride=1, padding=0)
    got = pc.phase_conv_dgrad(torch.from_numpy(dy).to(tdt),
                              torch.from_numpy(wgt).to(tdt), x.shape, 1, 0)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    tol = 1e-5 if dtype == "float32" else 1e-2
    for want in (want_vjp, want_kernel):
        _assert_scaled(got.float().numpy(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("k,stride,c,co,fwd,dgrad", [
    (1, 1, 16, 32, "small_1x1", "small_1x1"),     # Nano's five
    (1, 1, 32, 16, "small_1x1", "small_1x1"),
    (1, 1, 16, 16, "small_1x1", "small_1x1"),
    (1, 1, 8, 64, "small_1x1", "small_1x1"),      # C * Co = 512
    (1, 1, 24, 24, "wgmma_taps", "flipped:wgmma_taps"),   # 576: Tiny's
    (1, 1, 32, 64, "wgmma_taps", "flipped:wgmma_taps"),
    (1, 2, 16, 24, "direct", "wgmma_classes"),    # stride 2
    (1, 1, 12, 16, "direct", "cuda_cores"),       # C no multiple of 8
    (3, 1, 16, 16, "wgmma_taps", "flipped:wgmma_taps"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_1x1_takes_exactly_its_shapes(k, stride, c, co, fwd, dgrad,
                                            dtype):
    """``small_1x1`` forward and data gradient for the 1x1 stride-1 convs
    with C and Co multiples of 8 and C * Co at most SMALL_1X1, at stride 1
    only; the other shapes keep their variants."""
    p = (k - 1) // 2
    h = 104
    ho, wo = pc.out_hw(h, h, k, stride, p)
    assert pc.small_1x1_fits(k, stride, c, co) == (fwd == "small_1x1")
    assert pc.kernel_variant((8, h, h, c), (k, k, c, co), stride, p,
                             dtype) == fwd
    assert pc.dgrad_variant((8, ho, wo, co), (k, k, c, co), stride, p,
                            dtype) == dgrad
    assert pc.wgrad_variant((8, h, h, c), co, k, stride, dtype) == (
        "cuda_cores" if c % 8 else "wgmma")


def _split(k_in, n_out):
    """``conv1x1_small_kernel``'s split of a warp (its ``Split``): CG output
    channels a thread, G threads a pixel, S pixels a warp."""
    cg = 4 if k_in <= 32 else 2
    g = n_out // cg
    return cg, g, 32 // g


def _walk_small_1x1(x2d, w, transpose_w, blocks):
    """``conv1x1_small_kernel``'s walk on the host: block ``b`` of
    ``blocks`` takes tiles ``b, b + blocks, ...`` of TILE consecutive
    pixels, each one contiguous bulk copy (a multiple of 16 bytes) into
    ring stage ``i % STAGES`` of its ``i``-th tile; lane ``l`` of warp
    ``v`` computes output channels ``c0 .. c0 + CG`` of the tile's pixels
    ``v * S + l // G + j * warps * S`` below M, ``c0 = (l % G) * CG``, from
    its registers' weights.  Returns the output and how often each output
    value was stored."""
    m, k_in = x2d.shape
    wk = w.reshape(w.shape[2], w.shape[3]).double()
    wk = wk.t() if transpose_w else wk          # [K, N]
    n_out = wk.shape[1]
    cg, g, s = _split(k_in, n_out)
    warps = THREADS // 32
    tile_m = TILE
    tiles = -(-m // tile_m)
    es = x2d.element_size()
    y = torch.zeros((m, n_out), dtype=torch.float64)
    stores = np.zeros((m, n_out), np.int64)
    for b in range(min(tiles, blocks)):
        for i, tile in enumerate(range(b, tiles, blocks)):
            m0 = tile * tile_m
            rows = min(tile_m, m - m0)
            assert (rows * k_in * es) % 16 == 0
            ring = torch.zeros((tile_m, k_in), dtype=torch.float64)
            ring[:rows] = x2d[m0:m0 + rows].double()   # its ring stage
            for v in range(warps):
                for lane in range(32):
                    slot, c0 = lane // g, (lane % g) * cg
                    if slot >= s:
                        continue          # an idle lane
                    for r in range(v * s + slot, rows, warps * s):
                        y[m0 + r, c0:c0 + cg] = ring[r] @ wk[:, c0:c0 + cg]
                        stores[m0 + r, c0:c0 + cg] += 1
    return y, stores


@pytest.mark.parametrize("m,k_in,n_out,blocks", [
    (8 * 80 * 80, 16, 32, 1056),     # Nano at 320 px: 400 tiles, one each
    (8 * 104 * 104, 32, 16, 528),    # 416 px: 676 tiles, some blocks two
    (2 * 13 * 13, 16, 16, 1),        # one block walks all its tiles
    (2 * 13 * 13, 8, 24, 2),         # G = 6 threads a pixel: idle lanes
    (2 * 13 * 13, 64, 8, 3),         # K = 64: two channels a thread
])
def test_small_1x1_tile_walk_stores_every_output_once(m, k_in, n_out,
                                                      blocks):
    """The walk over a ragged M stores every output value exactly once; on
    a small M it computes the conv (forward) and its data gradient (the
    weights read transposed) as the plain versions do."""
    cg, g, s = _split(k_in, n_out)
    assert g * cg == n_out and 1 <= s * g <= 32
    warps, tile_m = THREADS // 32, TILE
    tiles = -(-m // tile_m)
    # the pixel of every (tile, warp, slot, round), all tiles at once
    rounds = -(-tile_m // (warps * s))
    ids = (np.arange(tiles)[:, None, None, None] * tile_m
           + s * np.arange(warps)[None, :, None, None]
           + np.arange(s)[None, None, :, None]
           + warps * s * np.arange(rounds)[None, None, None, :])
    local = ids - np.arange(tiles)[:, None, None, None] * tile_m
    ids = ids[(local < tile_m) & (ids < m)]
    assert np.array_equal(np.bincount(ids, minlength=m),
                          np.ones(m, np.int64))
    if m > 1000:
        return
    rng = np.random.RandomState(m + k_in)
    x = torch.from_numpy(rng.randn(2, 13, 13, k_in).astype(np.float32))
    w = torch.from_numpy(rng.randn(1, 1, k_in, n_out).astype(np.float32))
    y, stores = _walk_small_1x1(x.reshape(-1, k_in), w, False, blocks)
    assert (stores == 1).all()
    want = pc.phase_conv_reference(x, w, 1, 0).double().reshape(m, n_out)
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
    # the data gradient: dy has Co = n_out channels, dx C = k_in; the kernel
    # then reads K = n_out input and writes N = k_in output channels
    if k_in * n_out <= pc.SMALL_1X1:
        dy = torch.from_numpy(rng.randn(2, 13, 13, n_out).astype(np.float32))
        dx, stores = _walk_small_1x1(dy.reshape(-1, n_out), w, True, blocks)
        assert (stores == 1).all()
        want = pc.phase_conv_dgrad_reference(dy, w, x.shape, 1, 0).double()
        assert torch.allclose(dx, want.reshape(m, k_in), rtol=1e-5,
                              atol=1e-5)


def test_small_1x1_shared_memory_fits_every_admitted_shape():
    """Every (K, N) the variant admits, both ways and in both types: the
    ring of STAGES tiles of K values a pixel and its barriers (the kernel's
    ``smem_bytes``) within a block's 227 KB, a thread's weights in at most
    128 registers, and every N split into whole channel groups."""
    pairs = [(k, n) for k in range(8, 65, 8) for n in range(8, 65, 8)
             if k * n <= pc.SMALL_1X1]
    assert (64, 8) in pairs and (8, 64) in pairs and (16, 32) in pairs
    assert len(pairs) == 20
    for k_in, n_out in pairs:
        assert pc.small_1x1_fits(1, 1, k_in, n_out)
        cg, g, s = _split(k_in, n_out)
        assert k_in * cg <= 128 and g * cg == n_out and s >= 1
        for es in (4, 2):
            assert STAGES * (TILE * k_in * es + 8) <= 227 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [96, 64, 32])
def test_pack_rows_in_n_tiles_rebuilds_x_stem(tile, dtype):
    """YOLOX-X's stem (6x6/s2, 3 -> 80) packed in N tiles of ``tile``
    channels: each tile's runs, un-permuted, hold exactly the split (fp32)
    or the values (bf16) of its channels of the flat weights, zero past
    K = 108 and past Co = 80; the tiles' products rebuild the conv within
    1e-5 of its scale."""
    k, c, co = 6, 3, 80
    rng = np.random.RandomState(tile)
    w = torch.from_numpy((rng.randn(k, k, c, co) / 8).astype(np.float32))
    w = w.to(dtype)
    packed = pc._pack_rows(w, tile)
    nt, runs = -(-co // tile), pc._rows_runs(k, c, dtype)
    per = 32 if dtype == torch.float32 else 64
    flat = torch.zeros((runs * per, nt * tile), dtype=dtype)
    flat[:k * k * c, :co] = w.reshape(k * k * c, co)
    inverse = np.argsort(pc.K_ORDER["wgmma_rows"])
    parts = []
    for t in range(nt):
        mine = packed[t * runs:(t + 1) * runs]
        if dtype == torch.float32:
            assert tuple(mine.shape) == (runs, 2, tile, 32)
            # [run, hi/lo, N, permuted K] -> [hi/lo, run * 32, N]
            got = mine[..., inverse].permute(1, 0, 3, 2).reshape(
                2, runs * 32, tile)
            hi, lo = pc.split_tf32(flat[:, t * tile:(t + 1) * tile])
            assert torch.equal(got[0], hi) and torch.equal(got[1], lo)
            parts.append(got.double().sum(0))
        else:
            assert tuple(mine.shape) == (runs, tile, 64)
            got = mine.permute(0, 2, 1).reshape(runs * 64, tile)
            assert torch.equal(got, flat[:, t * tile:(t + 1) * tile])
            parts.append(got.double())
    weights = torch.cat(parts, 1)                   # [runs * per, nt * tile]
    assert not weights[k * k * c:].any() and not weights[:, co:].any()
    x = torch.from_numpy(rng.randn(1, 8, 12, c).astype(np.float32)).to(dtype)
    cols = F.unfold(F.pad(x.double().permute(0, 3, 1, 2), (2, 2, 2, 2)),
                    k, stride=2)                    # [1, c * k * k, L]
    # the flat K order of the rows: 3k ky + 3 kx + c
    cols = cols.reshape(1, c, k, k, -1).permute(0, 2, 3, 1, 4).reshape(
        1, k * k * c, -1)
    got = (cols[0].t() @ weights[:k * k * c, :co]).reshape(4, 6, co)
    want = F.conv2d(x.double().permute(0, 3, 1, 2),
                    w.double().permute(3, 2, 0, 1), stride=2,
                    padding=2).permute(0, 2, 3, 1)[0]
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-5 * scale
    assert pc.rows_tile(800, co, k, torch.float32) == (64, 2)
    assert pc.rows_tile(640, co, k, torch.float32) == (96, 1)
    assert pc.rows_tile(1184, co, k, torch.float32) is None
