"""The widened tensor-core layouts of the port's phase_conv, on the CPU: the
packed weights of ``wgmma_taps`` for channel runs that pass C (zero weights
where the kernel reads zeros or, at stride 2, the next phase's channels) and
for Co in N tiles with a masked tail, the stems' flat-row weights of
``wgmma_rows`` for Co up to 96 and the 3x3/s1 stem, the weight gradient's M
parts and N tiles emulated chunk by chunk, the plain version against the JAX
Pallas kernel at the new channel counts, and the variants every model of
``exps/default/`` and 24p-s takes.  The kernels run only on the card
(tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from eop_tpu.ops.pallas import conv_small_c as jax_pc
from eop_tpu_torch.exp import get_exp
from eop_tpu_torch.ops import phase_conv as pc
from eop_tpu_torch.ops.blocks import BaseConv

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(k, c, co, h, w, dtype, seed=0, batch=2):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(batch, h, w, c).astype(np.float32))
    wgt = torch.from_numpy((rng.randn(k, k, c, co) / np.sqrt(k * k * c))
                           .astype(np.float32))
    return x.to(dtype), wgt.to(dtype)


def _conv64(x, w, s, p):
    """The conv in float64 on the inputs' own (possibly bf16) values."""
    return F.conv2d(x.double().permute(0, 3, 1, 2),
                    w.double().permute(3, 2, 0, 1), stride=s,
                    padding=p).permute(0, 2, 3, 1)


def _close(got, want, tol=1e-5):
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol * scale


def _emulate_taps(x, w, s, p):
    """``conv_taps_kernel`` on the host: per tap, run of channels and N
    tile, the A box as the tensor map gives it (zero outside x and past C;
    at stride 2 a run past C of an even-phase tap reads the odd-phase
    pixel's first channels), gathered in the fp32 fragment order, times the
    packed weights; channels past Co are dropped as the masked store drops
    them.  Returns the output and the padded tail."""
    k, _, c, co = w.shape
    b, h, wd, _ = x.shape
    ho, wo = pc.out_hw(h, wd, k, s, p)
    run, (tile, nt) = pc.taps_run(c, w.dtype), pc.co_tiles(co)
    runs = -(-c // run)
    packed = pc._pack_taps(w).double()
    fp32 = w.dtype == torch.float32
    assert tuple(packed.shape) == ((k * k, runs, 2 * nt, tile, 32) if fp32
                                   else (k * k, runs, nt * tile, run))
    xp = torch.zeros((b, h + 2 * p + 2, wd + 2 * p + 2, 2 * c),
                     dtype=torch.float64)
    xp[:, p:p + h, p:p + wd, :c] = x.double()
    if s == 2:   # the phase view's channel c + C: the next pixel's channel c
        xp[:, p:p + h, p - 1:p + wd - 1, c:] = x.double()
    out = torch.zeros((b, ho, wo, nt * tile), dtype=torch.float64)
    order = pc.K_ORDER["wgmma_taps"]
    for ky in range(k):
        for kx in range(k):
            win = xp[:, ky: ky + s * ho: s, kx: kx + s * wo: s]
            if s == 2 and (kx - p) % 2:
                win = torch.cat([win[..., :c], torch.zeros_like(win[..., c:])],
                                -1)
            if s == 1:
                win = torch.cat([win[..., :c], torch.zeros_like(win[..., c:])],
                                -1)
            a = torch.zeros((b, ho, wo, runs * run), dtype=torch.float64)
            n = min(runs * run, 2 * c)
            a[..., :n] = win[..., :n]
            for r in range(runs):
                ar = a[..., r * run:(r + 1) * run]
                for t in range(nt):
                    if fp32:
                        wt = packed[ky * k + kx, r, 2 * t] + packed[
                            ky * k + kx, r, 2 * t + 1]
                        ar_ = ar[..., order]
                    else:
                        wt = packed[ky * k + kx, r, t * tile:(t + 1) * tile]
                        ar_ = ar
                    out[..., t * tile:(t + 1) * tile] += ar_ @ wt.T
    return out[..., :co], out[..., co:]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("co", [16, 24, 48, 96, 256])
@pytest.mark.parametrize("c", [16, 24, 48, 80])
def test_packed_taps_with_zero_filled_runs_and_n_tiles_rebuild_the_conv(
        c, co, dtype):
    """3x3/s2 (the phase view, whose runs past C read the next phase) and
    1x1/s1: the emulated kernel equals the conv within 1e-5 of its scale;
    the N tile's tail past Co is exactly zero."""
    for k, s, p, h in ((3, 2, 1, 10), (1, 1, 0, 6)):
        x, w = _inputs(k, c, co, h, h + 2, dtype, seed=c + co)
        got, tail = _emulate_taps(x, w, s, p)
        _close(got, _conv64(x, w, s, p))
        assert not tail.any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_taps_are_zero_past_c_and_co(dtype):
    k, c, co = 3, 24, 80
    _, w = _inputs(k, c, co, 4, 4, dtype)
    packed = pc._pack_taps(w)
    tile, nt = pc.co_tiles(co)
    run = pc.taps_run(c, dtype)
    if dtype == torch.float32:
        full = packed.reshape(k * k, -1, nt, 2, tile, 32)
        order = torch.tensor(pc.K_ORDER["wgmma_taps"])
        assert not full[..., co:, :].any()          # N past Co
        assert not full[:, :, :, :, :, order >= c].any()   # K past C
    else:
        assert run == 32
        assert not packed[:, :, co:].any() and not packed[..., c:].any()


def test_run_and_tile_rules():
    """Runs: fp32 32 channels; bf16 64 where that pads C no further.  N
    tiles: at most 128 wide, as few as that allows, multiples of 32."""
    assert [pc.taps_run(c, torch.bfloat16) for c in
            (16, 24, 32, 48, 64, 80, 96, 128, 160)] == [
        32, 32, 32, 64, 64, 32, 32, 64, 32]
    assert pc.taps_run(48, torch.float32) == 32
    assert {co: pc.co_tiles(co) for co in
            (16, 24, 32, 48, 64, 80, 96, 128, 160, 192, 256, 320)} == {
        16: (32, 1), 24: (32, 1), 32: (32, 1), 48: (64, 1), 64: (64, 1),
        80: (96, 1), 96: (96, 1), 128: (128, 1), 160: (96, 2),
        192: (96, 2), 256: (128, 2), 320: (128, 3)}


def _emulate_rows(x, w, s, p):
    """``conv_rows_kernel`` on the host: an output pixel's flat K index
    ``3k ky + 3 kx + c`` read from the zero-padded NHWC rows (the tail past
    k * k * 3 reads on in the last row, against zero weights), in runs of 32
    (fp32, fragment order) or 64 (bf16) times the packed weights."""
    k, _, c, co = w.shape
    b, h, wd, _ = x.shape
    ho, wo = pc.out_hw(h, wd, k, s, p)
    tile, _ = pc.co_tiles(co)
    packed = pc._pack_rows(w).double()
    fp32 = w.dtype == torch.float32
    per = 32 if fp32 else 64
    runs = packed.shape[0]
    flat = k * k * c
    rows = torch.zeros((b, h + 2 * p, (wd + 2 * p) * c + 64),
                       dtype=torch.float64)
    rows[:, p:p + h, p * c:(p + wd) * c] = x.double().reshape(b, h, wd * c)
    out = torch.zeros((b, ho, wo, tile), dtype=torch.float64)
    for oy in range(ho):
        for ox in range(wo):
            a = torch.zeros((b, runs * per), dtype=torch.float64)
            for f in range(runs * per):
                ky = min(f // (3 * k), k - 1)
                a[:, f] = rows[:, s * oy + ky, s * c * ox + f - 3 * k * ky]
            for r in range(runs):
                ar = a[:, r * per:(r + 1) * per]
                if fp32:
                    ar = ar[:, pc.K_ORDER["wgmma_rows"]]
                    wt = packed[r, 0] + packed[r, 1]
                else:
                    wt = packed[r]
                out[:, oy, ox] += ar @ wt.T
    assert runs * per >= flat
    return out[..., :co], out[..., co:]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,co", [(6, 16), (6, 24), (6, 48), (6, 64),
                                  (6, 80), (3, 32)])
def test_packed_stem_rows_rebuild_the_conv(k, co, dtype):
    """The 6x6/s2 stems on 3 channels (Nano 16 … X 80) and YOLOv3's 3x3/s1
    stem: the emulated rows kernel equals the conv within 1e-5; the N tile's
    tail is zero."""
    s, p = (2, 2) if k == 6 else (1, 1)
    x, w = _inputs(k, 3, co, 8, 12, dtype, seed=co)
    got, tail = _emulate_rows(x, w, s, p)
    _close(got, _conv64(x, w, s, p))
    assert not tail.any()
    runs = pc._pack_rows(w).shape[0]
    assert runs == {(6, True): 4, (6, False): 2, (3, True): 1,
                    (3, False): 1}[(k, dtype == torch.float32)]


@pytest.mark.parametrize("shape", [
    (3, 2, 1, 12, 14, 80, 160),     # 240 rows a ky: two M parts; 2 N tiles
    (3, 1, 1, 10, 9, 24, 48),       # C past its run of 32: zero-filled
    (1, 1, 0, 7, 40, 160, 320),     # 3 warpgroups; 3 N tiles, masked tail
    (3, 2, 1, 8, 70, 128, 256),     # YOLOX-L's dark3 down conv
    (6, 2, 2, 16, 24, 3, 80),       # X's stem: flat rows, a 96-wide N tile
])
def test_wgrad_m_parts_and_n_tiles_give_the_weight_gradient(shape):
    """The tensor-core weight gradient's plan emulated on the host: M tiles
    of whole ky values cut into parts of ``64 * warpgroups`` rows, N tiles
    of dy zero past Co, splits over chunks of 32 output pixels along one
    output row added in split order: equal to ``phase_conv_wgrad_reference``
    within 1e-5 of its scale."""
    k, s, p, h, w, c, co = shape
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(2, h, w, c)
    b, (ho, wo) = 2, pc.out_hw(h, w, k, s, p)
    dy = rng.randn(b, ho, wo, co)
    tiles = pc.wgrad_tiles(x.shape, co, k, s, torch.float32)
    nky, wgs, _ = tiles
    mparts = pc.wgrad_mparts(c, k, tiles)
    tile, ntiles = pc.co_tiles(co)
    chunk = pc.WGRAD_CHUNK
    cpr = -(-wo // chunk)
    chunks = b * ho * cpr
    splits, per = pc.wgrad_split_plan(chunks, k // nky * mparts * ntiles, 8,
                                      wgs)
    xp = np.zeros((b, h + 2 * p + k, w + 2 * p + s * chunk + k, c))
    xp[:, p:p + h, p:p + w] = x
    dyp = np.zeros((b, ho, cpr * chunk, ntiles * tile))
    dyp[:, :, :wo, :co] = dy
    group = nky * k * c          # dw rows of one group of ky values
    dw = np.zeros((k * k * c, co))
    for m in range(k // nky * mparts):
        r = m % mparts * 64 * wgs + np.arange(64 * wgs)
        r = r[r < group]
        ky = m // mparts * nky + r // (k * c)
        kx = (r % (k * c)) // c
        ch = r % c
        for t in range(ntiles):
            part = np.zeros((splits, len(r), tile))
            for sp in range(splits):
                for cid in range(sp * per, min((sp + 1) * per, chunks)):
                    row, wo0 = cid // cpr, (cid % cpr) * chunk
                    bb, oy = row // ho, row % ho
                    iy = s * oy - p + ky
                    ix = s * wo0 - p + s * np.arange(chunk)[None] + kx[:, None]
                    a = xp[bb, iy[:, None] + p, ix + p, ch[:, None]]
                    part[sp] += a @ dyp[bb, oy, wo0:wo0 + chunk,
                                        t * tile:(t + 1) * tile]
            got = part.sum(axis=0)
            assert not got[:, max(0, co - t * tile):].any()  # masked tail
            lo, hi = t * tile, min(co, (t + 1) * tile)
            dw[m // mparts * group + r, lo:hi] = got[:, :hi - lo]
    want = pc.phase_conv_wgrad_reference(torch.from_numpy(x),
                                         torch.from_numpy(dy), k, s, p)
    want = want.numpy().reshape(k * k * c, co)
    np.testing.assert_allclose(dw, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    assert mparts == (2 if shape[5] == 80 else 3 if shape[5] == 128 else 1)


@pytest.mark.parametrize("k,s,p,h,w,c,co", [
    (3, 2, 1, 16, 16, 24, 48),
    (1, 1, 0, 12, 12, 48, 24),
    (3, 1, 1, 10, 12, 80, 96),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_pallas_kernel_at_new_channels(k, s, p, h, w, c,
                                                         co, dtype):
    x, wgt = _inputs(k, c, co, h, w, torch.float32, seed=k + c)
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_pc.phase_conv(jnp.asarray(x.numpy(), jdt),
                                 jnp.asarray(wgt.numpy(), jdt),
                                 stride=s, padding=p)
    tdt = getattr(torch, dtype)
    got = pc.phase_conv(x.to(tdt), wgt.to(tdt), s, p)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 2e-1
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# every model of exps/default and 24p-s
MODELS = ["yolov3", "yolox-l", "yolox-m", "yolox-nano", "yolox-s",
          "yolox-tiny", "yolox-x", "yolox_24p_s"]
# Nano's 16- and 32-channel 1x1 convs take small_1x1 both ways (pc.SMALL_1X1)
SMALL_1X1_CONVS = {"dark2.0.pconv", "dark2.1.conv1", "dark2.1.conv2",
                   "dark2.1.m.0.conv1", "dark2.1.m.0.conv2.pconv"}


def _multiscale_sizes(exp):
    """Every training size of the exp's multiscale range (its
    ``random_resize``: ``random.randint`` includes both ends)."""
    lo, hi = exp.random_size or (
        int(exp.input_size[0] / 32) - exp.multiscale_range,
        int(exp.input_size[0] / 32) + exp.multiscale_range)
    factor = exp.input_size[1] / exp.input_size[0]
    return {(32 * s, 32 * int(s * factor)) for s in range(lo, hi + 1)}


def _early_convs(name):
    """(conv, k, stride, padding, H, W at 64 px, C, Co) of every phase_conv
    conv of the model, read by hooks from one CPU forward at 64 px."""
    exp = get_exp(exp_name=name)
    model = exp.get_model("cpu").eval()
    seen = []

    def record(conv_name):
        def hook(module, args):
            w, s, p = module.conv_args()
            co, c, k, _ = w.shape
            seen.append((conv_name, k, s, p, *args[0].shape[2:], c, co))
        return hook

    hooks = [m.register_forward_pre_hook(record(
        n.removeprefix("backbone.backbone.").removeprefix("backbone.")))
        for n, m in model.named_modules()
        if isinstance(m, BaseConv) and m.phase_conv]
    with torch.no_grad():
        model(torch.zeros(1, 3, 64, 64))
    for h in hooks:
        h.remove()
    return exp, seen


@pytest.mark.parametrize("name", MODELS)
def test_every_early_conv_takes_the_tensor_cores(name):
    """Every model of exps/default and 24p-s at its serving size and every
    size of its multiscale training range, fp32 and bf16: the stems on
    ``wgmma_rows`` (X's fp32 stem at 800 px in N tiles of 64), the other
    early convs on ``wgmma_taps`` but Nano's 16- and 32-channel 1x1 convs on
    ``small_1x1``, every weight gradient on ``wgmma``, every data gradient
    on ``small_1x1`` (Nano's five), ``flipped:wgmma_taps`` (stride 1) or
    ``wgmma_classes`` (stride 2): none on ``direct`` or ``cuda_cores``."""
    exp, convs = _early_convs(name)
    assert convs
    sizes = {tuple(exp.input_size), tuple(exp.test_size),
             *_multiscale_sizes(exp)}
    assert len(sizes) >= 11
    for size in sizes:
        f = size[0] / 64
        for conv, k, s, p, h, w, c, co in convs:
            h, w = int(h * f), int(w * f)
            ho, wo = pc.out_hw(h, w, k, s, p)
            for dtype in DTYPES:
                fwd = pc.kernel_variant((8, h, w, c), (k, k, c, co), s, p,
                                        dtype)
                wg = pc.wgrad_variant((8, h, w, c), co, k, s, dtype)
                small = name == "yolox-nano" and conv in SMALL_1X1_CONVS
                want = ("wgmma_rows" if c == 3 else "small_1x1" if small
                        else "wgmma_taps")
                assert fwd == want, (name, conv, size, dtype)
                assert wg == "wgmma", (name, conv, size, dtype)
                dg = pc.dgrad_variant((8, ho, wo, co), (k, k, c, co), s, p,
                                      dtype)
                want = ("small_1x1" if small else "flipped:wgmma_taps"
                        if s == 1 else "wgmma_classes")
                if c != 3:   # the stems' input is the image: no dgrad
                    assert dg == want, (name, conv, size, dtype)
                if name == "yolox-x" and c == 3:
                    assert pc.rows_tile(w, co, k, dtype) == (
                        (64, 2) if size[1] > 783 and dtype == torch.float32
                        else (96, 1)), (size, dtype)
