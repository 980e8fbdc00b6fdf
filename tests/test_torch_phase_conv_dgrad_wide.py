"""The data gradient of every early conv on the tensor cores, on the CPU: the
weight packing both tensor-core data gradients read, for C and Co that are
multiples of 8 (K runs over Co zero past it, N tiles over C zero past it),
the stride-2 parity-class kernel emulated with N tiles and zero-filled K
runs against the plain version and the JAX side, and the stride-1 route
that must hand its packed weights to ``wgmma_taps``, never to ``direct``.
The kernels run only on the card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from eop_tpu.ops.pallas import conv_small_c as jax_pc
from eop_tpu_torch.ops import phase_conv as pc

DTYPES = [torch.float32, torch.bfloat16]
# (C, Co) of the early convs whose data gradient moved to the tensor cores:
# Nano's 16 / 32, Tiny's 24 / 48, M's 48 / 24 (a 1x1 down), X's 80 / 160
# and 160 / 320
PAIRS = [(16, 32), (24, 48), (48, 24), (80, 160), (160, 320)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(k, c, co, dtype, seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.randn(k, k, c, co) / np.sqrt(k * k * co)).astype(np.float32)
    return torch.from_numpy(w).to(dtype)


def _unpack(packed, c, co, dtype):
    """Packed taps -> ``[n, runs * run (K over Co), tiles * tile (N over
    C)]`` in float64: fp32 hi + lo with the fragment's K order undone."""
    run, (tile, nt) = pc.taps_run(co, dtype), pc.co_tiles(c)
    runs, n = -(-co // run), packed.shape[0]
    p = packed.double()
    if dtype == torch.float32:
        p = p.reshape(n, runs, nt, 2, tile, run)
        p = p[..., np.argsort(pc.K_ORDER["wgmma_taps"])]
        p = p[:, :, :, 0] + p[:, :, :, 1]
    else:
        p = p.reshape(n, runs, nt, tile, run)
    return p.permute(0, 1, 4, 2, 3).reshape(n, runs * run, nt * tile)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,co", PAIRS)
def test_packing_of_wide_channels_is_the_flipped_forward_layout(c, co, dtype):
    """``pack_taps_reference(w, flip_taps(k))`` is, byte for byte, the
    forward's packing of the flipped weights, in the shape the packing
    kernel allocates; unpacked, every tap is ``w``'s flipped tap transposed
    (fp32: hi + lo within 1e-6), zero past Co in K and past C in N.  The
    parity classes' packing has the same layout and zeros."""
    k = 3
    w = _weights(k, c, co, dtype, seed=c + co)
    packed = pc.pack_taps_reference(w, pc.flip_taps(k))
    want = pc._pack_taps(pc.flipped_weights(w))
    assert packed.dtype == want.dtype and torch.equal(packed, want)
    assert tuple(packed.shape) == pc.pack_taps_shape(k * k, c, co, dtype)
    taps = pc.flip_taps(k)
    classes = [ky * k + kx for _, _, ts in pc.dgrad_class_plan(k, 1)
               for ky, kx, _, _ in ts]
    for src in (taps, classes):
        got = _unpack(pc.pack_taps_reference(w, src), c, co, dtype)
        assert not got[:, co:].any() and not got[:, :, c:].any()
        ref = w.double().reshape(k * k, c, co)[src].transpose(1, 2)
        tol = 1e-6 if dtype == torch.float32 else 0.0
        assert (got[:, :co, :c] - ref).abs().max().item() <= tol


def test_bf16_run_is_one_rule():
    """The packing's K run over Co is ``taps_run(Co)``, the forward's rule:
    64 where that pads Co no further than runs of 32 do (Co = 48 takes 64,
    where the packing's old rule took 32), else 32; fp32 always 32."""
    for co, run in ((16, 32), (24, 32), (32, 32), (48, 64), (64, 64),
                    (80, 32), (96, 32), (160, 32), (192, 64), (320, 64)):
        assert pc.pack_taps_shape(9, 32, co, torch.bfloat16)[-1] == run, co
        assert pc.pack_taps_shape(9, 32, co, torch.float32)[-1] == 32


def _dgrad_from_classes(dy, w, x_shape, padding):
    """The stride-2 data gradient as ``dgrad_tc_kernel`` computes it, from
    the packed class weights: a block per (class tile, N tile), K walked
    tap by tap in runs of ``taps_run(Co)`` whose box past Co reads zeros,
    the fp32 A fragments in the packed K order; dx[class pixels] of the
    tile += dy[class pixel + (oy, ox)] @ the tap's run; the store drops the
    N tile's channels past C, which must be zero."""
    k, _, c, co = w.shape
    b, h, wd, _ = x_shape
    run, (tile, nt) = pc.taps_run(co, w.dtype), pc.co_tiles(c)
    runs = -(-co // run)
    fp32 = w.dtype == torch.float32
    plan = pc.dgrad_class_plan(k, padding)
    taps = [t for _, _, ts in plan for t in ts]
    packed = pc.pack_taps_reference(
        w, [ky * k + kx for ky, kx, _, _ in taps]).double()
    assert tuple(packed.shape) == pc.pack_taps_shape(len(taps), c, co,
                                                     w.dtype)
    _, ho, wo, _ = dy.shape
    hc, wc = h // 2, wd // 2
    out = torch.zeros((b, h, wd, nt * tile), dtype=torch.float64)
    order = pc.K_ORDER["wgmma_taps"]
    j = 0
    for ph, pw, ts in plan:
        for _ in ts:
            _, _, oy, ox = taps[j]
            box = torch.zeros((b, hc, wc, runs * run), dtype=torch.float64)
            y0, y1 = max(0, -oy), min(hc, ho - oy)
            x0, x1 = max(0, -ox), min(wc, wo - ox)
            if y1 > y0 and x1 > x0:
                box[:, y0:y1, x0:x1, :co] = dy[:, y0 + oy:y1 + oy,
                                               x0 + ox:x1 + ox].double()
            for t in range(nt):
                for r in range(runs):
                    a = box[..., r * run:(r + 1) * run]
                    if fp32:
                        wt = packed[j, r, 2 * t] + packed[j, r, 2 * t + 1]
                        a = a[..., order]
                    else:
                        wt = packed[j, r, t * tile:(t + 1) * tile]
                    out[:, ph::2, pw::2, t * tile:(t + 1) * tile] += a @ wt.T
            j += 1
    assert not out[..., c:].any()
    return out[..., :c]


def _close(got, want, tol=1e-5):
    want = torch.as_tensor(np.asarray(want, np.float64))
    scale = max(1.0, want.abs().max().item())
    err = (got.double() - want).abs().max().item()
    assert err <= tol * scale, (err, tol * scale)


# 3x3/s2 data gradients of Tiny (24->48), M (48->96) and X (80->160,
# 160->320, two N tiles of 96), at a few pixels: (H, W, C, Co)
CLASS_SHAPES = [(16, 20, 24, 48), (12, 16, 48, 96), (16, 14, 80, 160),
                (8, 10, 160, 320)]


@pytest.mark.parametrize("h,w,c,co", CLASS_SHAPES)
def test_class_kernel_with_n_tiles_and_k_runs_gives_the_data_gradient(
        h, w, c, co):
    """fp32: the emulated class kernel equals ``phase_conv_dgrad_reference``,
    ``jax.vjp`` of ``lax.conv_general_dilated`` and the JAX package's Pallas
    ``phase_conv`` (interpret mode) on the transposed problem, all within
    1e-5 of the scale.  JAX cannot take ``jax.vjp`` through the Pallas call
    (reverse mode is not defined for it), so the JAX kernel computes the
    data gradient as the stride-1 conv of dy, zero-upsampled to the input's
    grid, with the flipped weights: dx[i] = sum_k dy_up[i + p - k] w[k]."""
    k, s, p = 3, 2, 1
    rng = np.random.RandomState(h + c)
    x = rng.randn(2, h, w, c).astype(np.float32)
    wgt = (rng.randn(k, k, c, co) / np.sqrt(k * k * c)).astype(np.float32)
    ho, wo = pc.out_hw(h, w, k, s, p)
    dy = rng.randn(2, ho, wo, co).astype(np.float32)
    got = _dgrad_from_classes(torch.from_numpy(dy), torch.from_numpy(wgt),
                              x.shape, p)
    _close(got, pc.phase_conv_dgrad_reference(
        torch.from_numpy(dy), torch.from_numpy(wgt), x.shape, s, p).numpy())

    def conv(x_, w_):
        return jax.lax.conv_general_dilated(
            x_, w_, window_strides=(s, s), padding=[(p, p), (p, p)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    _, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(wgt))
    _close(got, vjp(jnp.asarray(dy))[0])
    dy_up = np.zeros((2, h, w, co), np.float32)
    dy_up[:, ::2, ::2] = dy
    flipped = np.ascontiguousarray(wgt[::-1, ::-1].transpose(0, 1, 3, 2))
    with pltpu.force_tpu_interpret_mode():
        want = jax_pc.phase_conv(jnp.asarray(dy_up), jnp.asarray(flipped),
                                 stride=1, padding=k - 1 - p)
    _close(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,h,w,c,co", [(3, 8, 12, 24, 48), (1, 6, 10, 16, 24),
                                        (3, 10, 6, 48, 96)])
def test_class_kernel_in_both_types_and_at_k1(k, h, w, c, co, dtype):
    """The emulated class kernel on the inputs' own values (bf16: runs of 64
    over Co = 48, zero-filled past 48) equals the float64 plain version
    within 1e-5 of the scale, at 3x3/s2 and at 1x1/s2, whose three classes
    without a tap are written as zeros."""
    p = (k - 1) // 2
    rng = np.random.RandomState(k + c)
    wgt = _weights(k, c, co, dtype, seed=c)
    ho, wo = pc.out_hw(h, w, k, 2, p)
    dy = torch.from_numpy(rng.randn(2, ho, wo, co).astype(np.float32)).to(
        dtype)
    got = _dgrad_from_classes(dy, wgt, (2, h, w, c), p)
    _close(got, pc.phase_conv_dgrad_reference(
        dy.double(), wgt.double(), (2, h, w, c), 2, p).numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,co", [(16, 32), (32, 16), (16, 16)])
def test_flipped_small_1x1_resolves_to_wgmma_taps(c, co, dtype,
                                                   monkeypatch):
    """Nano's 1x1 data gradients at 104 px take ``small_1x1`` (one launch,
    the weights read transposed); the stride-1 tensor-core route they took
    before stays for comparisons (``_flipped``).  Its flipped conv (Co -> C)
    is of ``SMALL_1X1`` size, so the forward's own predicate would send it
    to ``small_1x1``, which reads HWIO weights.  ``phase_conv_dgrad`` hands
    the packed weights to ``wgmma_taps`` by name; the launcher refuses
    packed weights on any other variant."""
    dy_shape, w_shape = (8, 104, 104, co), (1, 1, c, co)
    assert pc.dgrad_variant(dy_shape, w_shape, 1, 0, dtype) == "small_1x1"
    flipped_shape = (1, 1, co, c)
    assert pc.kernel_variant(dy_shape, flipped_shape, 1, 0, dtype) == \
        "small_1x1"
    calls = []

    def launch(x, w, stride, padding, scale, shift, act, packed=None,
               variant=None):
        calls.append((tuple(w.shape), variant, tuple(packed.shape)))
        return x.new_empty((*x.shape[:3], w.shape[3])), variant

    # meta tensors stand in for CUDA ones: shapes only, nothing launches
    monkeypatch.setattr(pc, "_check_cuda_pair", lambda *a: None)
    monkeypatch.setattr(pc, "pack_taps", lambda w, taps: torch.empty(
        pc.pack_taps_shape(len(taps), c, co, w.dtype), device="meta"))
    monkeypatch.setattr(pc, "_launch_forward", launch)
    dy = torch.empty((2, 6, 6, co), dtype=dtype, device="meta")
    w = torch.empty(w_shape, dtype=dtype, device="meta")
    dx = pc.phase_conv_dgrad(dy, w, (2, 6, 6, c), 1, 0, _flipped=True)
    assert tuple(dx.shape) == (2, 6, 6, c)
    assert calls == [(flipped_shape, "wgmma_taps",
                      pc.pack_taps_shape(1, c, co, dtype))]
    assert pc.phase_conv.last_dgrad_variant == "flipped:wgmma_taps"
    with pytest.raises(ValueError, match="_flipped"):   # stride 2: classes
        pc.phase_conv_dgrad(torch.empty((2, 3, 3, co), device="meta"),
                            w, (2, 6, 6, c), 2, 0, _flipped=True)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="packed"):
        pc._launch_forward(torch.zeros((1, 4, 4, co), dtype=dtype),
                           torch.empty(flipped_shape, device="meta"), 1, 0,
                           None, None, None,
                           packed=torch.zeros(pc.pack_taps_shape(1, c, co,
                                                                 dtype)))
