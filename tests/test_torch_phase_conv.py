"""The port's phase_conv (eop_tpu_torch/ops/phase_conv.py) on the CPU: its
plain version against the JAX Pallas kernel in interpret mode and against
F.conv2d.  The CUDA kernel's own test is in test_torch_gpu.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from eop_tpu.ops.pallas import conv_small_c as jax_pc
from eop_tpu_torch.ops import phase_conv as pc

# the five cases of tests/test_pallas_conv.py: (k, stride, padding, H, W, C, Co)
CASES = [
    (1, 1, 0, 20, 20, 64, 32),
    (3, 1, 1, 16, 24, 32, 32),
    (3, 2, 1, 32, 40, 32, 64),
    (6, 2, 2, 32, 32, 3, 32),
    (3, 2, 1, 16, 16, 64, 128),
]

# the 8 convs the 24p-s main path runs through phase_conv (width 0.5), at
# 1/10 of the 640 px spatial size: (k, stride, padding, H, W, C, Co)
MAIN_PATH = {
    "stem": (6, 2, 2, 64, 64, 3, 32),
    "dark2_conv": (3, 2, 1, 32, 32, 32, 64),
    "dark2_csp.conv1": (1, 1, 0, 16, 16, 64, 32),
    "dark2_csp.conv2": (1, 1, 0, 16, 16, 64, 32),
    "dark2_csp.m0.conv1": (1, 1, 0, 16, 16, 32, 32),
    "dark2_csp.m0.conv2": (3, 1, 1, 16, 16, 32, 32),
    "dark2_csp.conv3": (1, 1, 0, 16, 16, 64, 64),
    "dark3_conv": (3, 2, 1, 16, 16, 64, 128),
}


def _inputs(k, s, c, co, h, w, batch=2):
    rng = np.random.RandomState(k * 10 + s)
    return (rng.randn(batch, h, w, c).astype(np.float32),
            (rng.randn(k, k, c, co) * 0.1).astype(np.float32))


@pytest.mark.parametrize("k,s,p,h,w,c,co", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_pallas_kernel(k, s, p, h, w, c, co, dtype):
    x, wgt = _inputs(k, s, c, co, h, w)
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_pc.phase_conv(jnp.asarray(x, jdt), jnp.asarray(wgt, jdt),
                                 stride=s, padding=p)
    tdt = getattr(torch, dtype)
    got = pc.phase_conv(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(wgt).to(tdt), s, p)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 2e-1
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("k,padding", [(1, 0), (3, 1), (5, 2), (6, 2), (4, 1)])
def test_phase_geometry_and_weights_equal_jax(k, padding):
    assert pc._phase_geometry(k, padding) == jax_pc._phase_geometry(k, padding)
    w = np.random.RandomState(k).randn(k, k, 3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        pc._phase_weights(torch.from_numpy(w), padding).numpy(),
        np.asarray(jax_pc._phase_weights(jnp.asarray(w), padding)))
    x = np.random.RandomState(1).randn(2, 6, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(
        pc._space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jax_pc._space_to_depth(jnp.asarray(x))))


@pytest.mark.parametrize("name", list(MAIN_PATH))
def test_plain_matches_conv2d_on_main_path_shapes(name):
    k, s, p, h, w, c, co = MAIN_PATH[name]
    x, wgt = _inputs(k, s, c, co, h, w)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wgt)
    got = pc.phase_conv(xt, wt, s, p)
    want = F.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                    stride=s, padding=p).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("k,s,p,shape", [
    (5, 2, 0, (1, 8, 8, 4)),    # padding outside the predicate
    (3, 3, 1, (1, 8, 8, 4)),    # stride 3
    (3, 1, 0, (1, 8, 8, 4)),    # stride 1 without "same" padding
    (3, 2, 1, (1, 7, 8, 4)),    # odd H at stride 2
])
def test_unsupported_arguments_raise(k, s, p, shape):
    x = torch.zeros(shape)
    w = torch.zeros((k, k, shape[3], 8))
    assert not pc.supported(k, s, p) or shape[1] % 2
    with pytest.raises(ValueError):
        pc.phase_conv(x, w, s, p)
    with pytest.raises(ValueError):
        pc.phase_conv(x, torch.zeros((k, k + 1, shape[3], 8)), 1, (k - 1) // 2)


# --- split TF32: the arithmetic of the tensor-core kernels, emulated in fp32

def _assert_split_exact(x):
    hi, lo = pc.split_tf32(torch.from_numpy(x))
    for part in (hi, lo):   # TF32 keeps 10 mantissa bits: the low 13 are clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi + lo rebuilds x to within one TF32 ulp of lo (lo's own rounding)
    ulp_lo = np.maximum(np.abs(lo.numpy()), np.finfo(np.float32).tiny) * 2.0 ** -10
    resid = np.abs(x.astype(np.float64) - hi.numpy().astype(np.float64)
                   - lo.numpy().astype(np.float64))
    assert (resid <= ulp_lo + 2.0 ** -149).all()
    # hi is x rounded to 11 significant bits: within half a TF32 ulp of x
    assert (np.abs(x - hi.numpy()) <= np.abs(x) * 2.0 ** -11 * (1 + 1e-6)).all()


def test_split_tf32_fixed_seed():
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32)
    _assert_split_exact(np.concatenate([x, np.float32([0.0, 1.0, -1.0, 3.0])]))


def test_split_tf32_hypothesis():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=200, deadline=None, database=None)
    @given(st.lists(st.floats(min_value=-(2.0 ** 100), max_value=2.0 ** 100, width=32,
                              allow_nan=False, allow_subnormal=False),
                    min_size=1, max_size=64))
    def check(values):
        _assert_split_exact(np.asarray(values, np.float32))

    check()


def _conv(xt, wt, s, p):
    return F.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                    stride=s, padding=p).permute(0, 2, 3, 1)


@pytest.mark.parametrize("name", list(MAIN_PATH))
def test_three_tf32_products_hold_fp32_accuracy_and_one_does_not(name):
    """Why the kernels split: lo*hi + hi*lo + hi*hi summed in fp32 stays
    within 1e-5 x scale of a float64 conv; hi*hi alone breaks 1e-4."""
    k, s, p, _, _, c, co = MAIN_PATH[name]
    size = 32
    rng = np.random.RandomState(k * 100 + c)
    xt = torch.from_numpy(rng.randn(2, size, size, c).astype(np.float32))
    wt = torch.from_numpy((rng.randn(k, k, c, co)
                           / np.sqrt(k * k * c)).astype(np.float32))
    want = _conv(xt.double(), wt.double(), s, p)
    scale = max(1.0, want.abs().max().item())
    (xh, xl), (wh, wl) = pc.split_tf32(xt), pc.split_tf32(wt)
    three = _conv(xl, wh, s, p) + _conv(xh, wl, s, p) + _conv(xh, wh, s, p)
    one = _conv(xh, wh, s, p)
    assert (three.double() - want).abs().max().item() <= 1e-5 * scale
    assert (one.double() - want).abs().max().item() > 1e-4 * scale


def _fragment_order(variant):
    """K order of a packed run, derived from how the kernel's threads load A:
    K step j reads positions 8j..8j+7; quad thread t feeds positions 8j+t and
    8j+t+4."""
    order = [None] * 32
    for j in range(4):
        for t in range(4):
            if variant == "wgmma_taps":   # t holds floats 8t..8t+7 of the run
                first, second = 8 * t + 2 * j, 8 * t + 2 * j + 1
            else:                         # t loads floats 8j+2t, 8j+2t+1
                first, second = 8 * j + 2 * t, 8 * j + 2 * t + 1
            order[8 * j + t], order[8 * j + t + 4] = first, second
    return order


@pytest.mark.parametrize("name", ["dark2_conv", "dark2_csp.conv1",
                                  "dark2_csp.m0.conv2", "dark3_conv"])
def test_packed_tap_weights_rebuild_the_conv(name):
    """The fp32 tensor-core layout [tap, run, (hi, lo), Co, 32]: A runs
    gathered in the kernel's fragment order times the packed weights give
    the conv."""
    k, s, p, h, w, c, co = MAIN_PATH[name]
    x, wgt = _inputs(k, s, c, co, h, w)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wgt)
    assert pc.K_ORDER["wgmma_taps"] == _fragment_order("wgmma_taps")
    packed = pc._pack_taps(wt)
    assert tuple(packed.shape) == (k * k, c // 32, 2, co, 32)
    ho, wo = pc.out_hw(h, w, k, s, p)
    xp = F.pad(xt, (0, 0, p, p, p, p))
    got = torch.zeros((x.shape[0], ho, wo, co), dtype=torch.float64)
    for ky in range(k):
        for kx in range(k):
            a = xp[:, ky: ky + s * ho: s, kx: kx + s * wo: s]
            for r in range(c // 32):
                run = a[..., 32 * r: 32 * r + 32][..., _fragment_order("wgmma_taps")]
                b = packed[ky * k + kx, r].sum(0)          # hi + lo
                got += torch.einsum("bhwq,oq->bhwo", run.double(), b.double())
    want = _conv(xt.double(), wt.double(), s, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_packed_stem_weights_rebuild_the_conv():
    """The stem layout [run, (hi, lo), Co, 32] over the flat K index
    18 ky + 3 kx + c: for one ky an output pixel's 18 values are consecutive
    floats of the zero-padded NHWC row."""
    k, s, p, h, w, c, co = MAIN_PATH["stem"]
    x, wgt = _inputs(k, s, c, co, h, w)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wgt)
    assert pc.K_ORDER["wgmma_rows"] == _fragment_order("wgmma_rows")
    packed = pc._pack_rows(wt)
    assert tuple(packed.shape) == (4, 2, co, 32)
    ho, wo = pc.out_hw(h, w, k, s, p)
    rows = F.pad(xt, (0, 0, p, p, p, p)).reshape(x.shape[0], h + 2 * p, -1)
    order = _fragment_order("wgmma_rows")
    weights = packed.sum(1).double()                     # hi + lo: [run, Co, 32]
    got = torch.zeros((x.shape[0], ho, wo, co), dtype=torch.float64)
    for oy in range(ho):
        for ox in range(wo):
            a = torch.zeros((x.shape[0], 128), dtype=torch.float64)
            for ky in range(k):
                a[:, 18 * ky: 18 * ky + 18] = rows[
                    :, s * oy + ky, s * c * ox: s * c * ox + 18]
            for r in range(4):
                run = a[:, 32 * r: 32 * r + 32][:, order]
                got[:, oy, ox] += run @ weights[r].T
    assert float(packed.permute(0, 3, 1, 2).reshape(128, -1)[
        [32 * r + q for r in range(4) for q in range(32)
         if 32 * r + order[q] >= 108]].abs().max()) == 0.0
    want = _conv(xt.double(), wt.double(), s, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_packed_bf16_weights_are_k_major_runs():
    wt = torch.from_numpy(_inputs(3, 2, 64, 128, 8, 8)[1]).bfloat16()
    packed = pc._pack_taps(wt)                       # [tap, run, Co, 64]
    assert tuple(packed.shape) == (9, 1, 128, 64) and packed.dtype == wt.dtype
    np.testing.assert_array_equal(
        packed[4, 0].float().numpy(), wt[1, 1].float().numpy().T)
    ws = torch.from_numpy(_inputs(6, 2, 3, 32, 8, 8)[1]).bfloat16()
    rows = pc._pack_rows(ws)                         # [run, Co, 64]
    assert tuple(rows.shape) == (2, 32, 64)
    flat = rows.permute(0, 2, 1).reshape(128, 32).float().numpy()
    np.testing.assert_array_equal(flat[:108], ws.reshape(108, 32).float().numpy())
    assert not flat[108:].any()


def test_packed_weights_are_cached_per_tensor_and_version():
    w = torch.randn(3, 3, 32, 32)
    a = pc.packed_weights(w, "wgmma_taps")
    assert pc.packed_weights(w, "wgmma_taps") is a
    w.mul_(2.0)
    b = pc.packed_weights(w, "wgmma_taps")
    assert b is not a
    np.testing.assert_array_equal(b.numpy(), pc._pack_taps(w).numpy())


@pytest.mark.parametrize("shape,want", [
    ((8, 640, 640, 3, 6, 2, 2, 32), "wgmma_rows"),
    ((8, 320, 320, 32, 3, 2, 1, 64), "wgmma_taps"),
    ((8, 160, 160, 64, 1, 1, 0, 32), "wgmma_taps"),
    ((8, 160, 160, 32, 3, 1, 1, 32), "wgmma_taps"),
    ((8, 160, 160, 64, 3, 2, 1, 128), "wgmma_taps"),
    ((8, 104, 104, 16, 1, 1, 0, 32), "small_1x1"),   # YOLOX-Nano, 416 px
    ((8, 104, 104, 32, 1, 1, 0, 16), "small_1x1"),
    ((8, 800, 800, 3, 6, 2, 2, 80), "wgmma_rows"),   # YOLOX-X, 800 px
    ((1, 8, 8, 16, 1, 2, 0, 24), "direct"),          # a small 1x1 at stride 2
    ((1, 8, 8, 4, 3, 1, 1, 8), "direct"),
    ((1, 8, 8, 32, 3, 1, 1, 33), "direct"),
    ((1, 8, 8, 32, 5, 1, 2, 32), "direct"),
    ((1, 8, 6, 3, 6, 2, 2, 32), "direct"),      # W no multiple of 4
])
def test_kernel_variant_is_chosen_by_shape(shape, want):
    b, h, w, c, k, s, p, co = shape
    assert pc.kernel_variant((b, h, w, c), (k, k, c, co), s, p,
                             torch.float32) == want
    if want == "wgmma_rows":    # bf16 rows must be 16-byte multiples too
        assert pc.kernel_variant((b, h, w, c), (k, k, c, co), s, p,
                                 torch.bfloat16) == "wgmma_rows"
        assert pc.kernel_variant((b, h, w + 4, c), (k, k, c, co), s, p,
                                 torch.bfloat16) == "direct"


# --- the fused epilogue

@pytest.mark.parametrize("k,s,p,h,w,c,co", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_with_epilogue_matches_jax_kernel_then_affine_silu(
        k, s, p, h, w, c, co, dtype):
    import jax

    x, wgt = _inputs(k, s, c, co, h, w)
    rng = np.random.RandomState(co + k)
    scale = rng.uniform(0.5, 2.0, co).astype(np.float32)
    shift = rng.uniform(-1.0, 1.0, co).astype(np.float32)
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        y = jax_pc.phase_conv(jnp.asarray(x, jdt), jnp.asarray(wgt, jdt),
                              stride=s, padding=p)
    want = jax.nn.silu(y.astype(jnp.float32) * scale + shift)
    tdt = getattr(torch, dtype)
    got = pc.phase_conv(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(wgt).to(tdt), s, p,
                        scale=torch.from_numpy(scale),
                        shift=torch.from_numpy(shift), act="silu")
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    tol = (1e-4 if dtype == "float32" else 1e-2) * max(1.0, np.abs(want).max())
    assert np.abs(got.float().numpy() - want).max() <= tol
    # affine alone, and the epilogue's argument checks
    lin = pc.phase_conv(torch.from_numpy(x), torch.from_numpy(wgt), s, p,
                        scale=torch.from_numpy(scale),
                        shift=torch.from_numpy(shift))
    base = pc.phase_conv(torch.from_numpy(x), torch.from_numpy(wgt), s, p)
    np.testing.assert_allclose(lin.numpy(), base.numpy() * scale + shift,
                               atol=1e-5, rtol=1e-5)


def test_epilogue_arguments_are_checked():
    x, w = torch.zeros((1, 8, 8, 4)), torch.zeros((3, 3, 4, 8))
    with pytest.raises(ValueError):
        pc.phase_conv(x, w, 1, 1, scale=torch.ones(8))
    with pytest.raises(ValueError):
        pc.phase_conv(x, w, 1, 1, scale=torch.ones(4), shift=torch.ones(4))
    with pytest.raises(ValueError):
        pc.phase_conv(x, w, 1, 1, act="relu")
