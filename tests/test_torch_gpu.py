"""Tests that need a CUDA card: the hand-written kernels against their plain
versions, and the port's model on the card against the CPU.  They import
neither JAX nor eop_tpu, so they run where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from eop_tpu_torch.ops import phase_conv as pc

# (k, stride, padding, H, W, C, Co): the JAX package's phase_conv cases, and
# the 24p-s main-path convs at 1/10 of 640 px
SHAPES = [
    (1, 1, 0, 20, 20, 64, 32),
    (3, 1, 1, 16, 24, 32, 32),
    (3, 2, 1, 32, 40, 32, 64),
    (6, 2, 2, 32, 32, 3, 32),
    (3, 2, 1, 16, 16, 64, 128),
    (6, 2, 2, 64, 64, 3, 32),
    (3, 2, 1, 32, 32, 32, 64),
    (1, 1, 0, 16, 16, 64, 32),
    (1, 1, 0, 16, 16, 32, 32),
    (3, 1, 1, 16, 16, 32, 32),
    (1, 1, 0, 16, 16, 64, 64),
    (3, 2, 1, 16, 16, 64, 128),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(i, shape, tdt, device, batch=2):
    k, s, p, h, w, c, co = shape
    rng = np.random.RandomState(i)
    x = torch.from_numpy(rng.randn(batch, h, w, c).astype(np.float32))
    wgt = torch.from_numpy((rng.randn(k, k, c, co) * 0.1).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, co).astype(np.float32))
    shift = torch.from_numpy(rng.uniform(-1.0, 1.0, co).astype(np.float32))
    return (x.to(device, tdt), wgt.to(device, tdt), scale.to(device),
            shift.to(device))


def _assert_kernel_matches_plain(x, wgt, s, p, tol, **epilogue):
    got = pc.phase_conv(x, wgt, s, p, **epilogue)
    want = pc.phase_conv_reference(x, wgt, s, p, **epilogue)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == x.dtype
    bound = tol * max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= bound, (tuple(x.shape), tuple(wgt.shape), s, p, epilogue.keys(),
                          pc.phase_conv.last_variant, err, bound)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_phase_conv_kernel_matches_plain(cuda, dtype, tol):
    """Every variant, with and without the fused scale, shift and SiLU."""
    tdt = getattr(torch, dtype)
    before = pc.phase_conv.launches
    seen = set()
    for i, shape in enumerate(SHAPES):
        x, wgt, scale, shift = _case(i, shape, tdt, cuda)
        _assert_kernel_matches_plain(x, wgt, shape[1], shape[2], tol)
        _assert_kernel_matches_plain(x, wgt, shape[1], shape[2], tol,
                                     scale=scale, shift=shift)
        _assert_kernel_matches_plain(x, wgt, shape[1], shape[2], tol,
                                     scale=scale, shift=shift, act="silu")
        seen.add(pc.phase_conv.last_variant)
    assert pc.phase_conv.launches - before == 3 * len(SHAPES)
    assert seen == {"wgmma_taps", "wgmma_rows"}


@pytest.mark.gpu
def test_phase_conv_variant_of_each_main_path_shape(cuda):
    want = ["wgmma_rows"] + ["wgmma_taps"] * 7
    for i, (shape, variant) in enumerate(zip(SHAPES[5:], want)):
        x, wgt, _, _ = _case(i, shape, torch.float32, cuda)
        pc.phase_conv(x, wgt, shape[1], shape[2])
        assert pc.phase_conv.last_variant == variant, shape
        assert pc.kernel_variant(x.shape, wgt.shape, shape[1], shape[2],
                                 x.dtype) == variant


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (3, 1, 1, 8, 8, 4, 8),       # narrow channels
    (3, 1, 1, 12, 20, 32, 33),   # odd Co
    (3, 2, 1, 16, 12, 44, 64),   # C no multiple of 8
    (5, 1, 2, 9, 11, 32, 32),    # a kernel size without a tensor-core path
    (6, 2, 2, 12, 10, 3, 32),    # a stem whose rows are not 16-byte multiples
    (4, 2, 1, 16, 16, 8, 16),
])
def test_phase_conv_odd_shapes_take_the_direct_variant(cuda, shape):
    for tdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        x, wgt, scale, shift = _case(7, shape, tdt, cuda, batch=3)
        _assert_kernel_matches_plain(x, wgt, shape[1], shape[2], tol)
        assert pc.phase_conv.last_variant == "direct"
        _assert_kernel_matches_plain(x, wgt, shape[1], shape[2], tol,
                                     scale=scale, shift=shift, act="silu")
        assert pc.phase_conv.last_variant == "direct"


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (1, 1, 0, 13, 27, 96, 128),   # ragged tiles, three channel runs
    (3, 1, 1, 21, 9, 64, 64),
    (3, 2, 1, 26, 38, 32, 32),
    (3, 2, 1, 6, 6, 128, 128),
    (6, 2, 2, 6, 8, 3, 32),       # fewer rows than the stem's ring
    (6, 2, 2, 70, 132, 3, 32),    # three 64-pixel chunks, the last ragged
    (3, 2, 1, 16, 12, 48, 64),    # C no multiple of 32: a zero-filled run
])
def test_phase_conv_tensor_core_variants_on_ragged_shapes(cuda, shape):
    for batch in (1, 5):
        x, wgt, scale, shift = _case(batch, shape, torch.float32, cuda, batch)
        _assert_kernel_matches_plain(x, wgt, shape[1], shape[2], 1e-4)
        assert pc.phase_conv.last_variant.startswith("wgmma")
        _assert_kernel_matches_plain(x, wgt, shape[1], shape[2], 1e-4,
                                     scale=scale, shift=shift, act="silu")
    x, wgt, scale, shift = _case(2, shape, torch.bfloat16, cuda)
    _assert_kernel_matches_plain(x, wgt, shape[1], shape[2], 1e-2,
                                 scale=scale, shift=shift, act="silu")
    # a bf16 stem row of 132 px is no multiple of 16 bytes
    assert pc.phase_conv.last_variant == (
        "direct" if shape[:2] == (6, 2) and shape[4] % 8 else
        "wgmma_rows" if shape[0] == 6 else "wgmma_taps")


@pytest.mark.gpu
def test_phase_conv_kernel_raises_instead_of_falling_back(cuda):
    x = torch.zeros((1, 8, 8, 4), device=cuda)
    w = torch.zeros((3, 3, 4, 8), device=cuda)
    with pytest.raises(ValueError):   # NCHW-strided input
        pc.phase_conv(x.permute(0, 2, 1, 3), w, 1, 1)
    with pytest.raises(ValueError):   # mixed devices
        pc.phase_conv(x, w.cpu(), 1, 1)
    with pytest.raises(ValueError):   # unsupported dtype
        pc.phase_conv(x.half(), w.half(), 1, 1)
    with pytest.raises(ValueError):   # epilogue vectors on the wrong device
        pc.phase_conv(x, w, 1, 1, scale=torch.ones(8), shift=torch.zeros(8))


@pytest.mark.gpu
def test_model_on_card_matches_cpu(cuda):
    from eop_tpu_torch.exp import Exp24P

    exp = Exp24P()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.125, 3
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 255, (2, 64, 64, 3)).astype(np.float32))
    heads = {}
    for dev in ("cpu", "cuda"):
        model = exp.get_model(dev)
        before = pc.phase_conv.launches
        with torch.inference_mode():
            out, _ = model(x.to(dev).permute(0, 3, 1, 2))
        heads[dev] = [o.cpu() for o in out]
        launched = pc.phase_conv.launches - before
        assert launched == (8 if dev == "cuda" else 0)
        # eval mode without autograd: BN and SiLU ran in the kernels' epilogue
        assert all(m._bn_cache[1] is not None for m in model.modules()
                   if getattr(m, "phase_conv", False) is True)
    for g, c in zip(heads["cuda"], heads["cpu"]):
        np.testing.assert_allclose(g.numpy(), c.numpy(), atol=1e-3, rtol=1e-3)


# ---- backward kernels (csrc/phase_conv_backward.cu) ----

RAGGED_BACKWARD = [
    (3, 1, 1, 8, 8, 4, 8),       # narrow channels
    (3, 1, 1, 12, 20, 32, 33),   # odd Co
    (3, 2, 1, 16, 12, 48, 64),   # C no multiple of 32
    (5, 1, 2, 9, 11, 32, 32),
    (6, 2, 2, 12, 10, 3, 32),
    (4, 2, 1, 16, 16, 8, 16),
    (1, 2, 0, 8, 6, 16, 24),     # stride 2 with parity classes no tap reaches
    (3, 2, 1, 26, 38, 32, 32),   # output rows that are no multiple of a chunk
    (1, 1, 0, 13, 27, 96, 128),
    (3, 1, 1, 21, 9, 64, 64),
    (3, 1, 1, 5, 7, 70, 130),    # several ragged tiles of dw
]


def _grad_case(i, shape, tdt, device, batch=2):
    k, s, p, h, w, c, co = shape
    x, wgt, _, _ = _case(i, shape, tdt, device, batch)
    ho, wo = pc.out_hw(h, w, k, s, p)
    rng = np.random.RandomState(100 + i)
    dy = torch.from_numpy(rng.randn(batch, ho, wo, co).astype(np.float32))
    return x, wgt, dy.to(device, tdt)


def _assert_close_scaled(got, want, tol, what):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    bound = tol * max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= bound, (what, err, bound)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape", SHAPES + RAGGED_BACKWARD)
def test_backward_kernels_match_plain(cuda, shape, dtype, tol):
    """dgrad and wgrad against their plain versions; wgrad twice, bit-equal."""
    tdt = getattr(torch, dtype)
    k, s, p = shape[:3]
    for batch in (1, 3):
        x, wgt, dy = _grad_case(batch, shape, tdt, cuda, batch)
        before = (pc.phase_conv.dgrad_launches, pc.phase_conv.wgrad_launches)
        dw = pc.phase_conv_wgrad(x, dy, k, s, p)
        _assert_close_scaled(
            dw, pc.phase_conv_wgrad_reference(x, dy, k, s, p), tol,
            ("wgrad", shape, batch))
        assert torch.equal(dw, pc.phase_conv_wgrad(x, dy, k, s, p))
        dx = pc.phase_conv_dgrad(dy, wgt, x.shape, s, p)
        _assert_close_scaled(
            dx, pc.phase_conv_dgrad_reference(dy, wgt, x.shape, s, p), tol,
            ("dgrad", shape, batch, pc.phase_conv.last_dgrad_variant))
        assert pc.phase_conv.last_dgrad_variant == pc.dgrad_variant(
            dy.shape, wgt.shape, s, p, tdt)
        assert pc.phase_conv.last_wgrad_variant == pc.wgrad_variant(
            x.shape, shape[6], k, s, tdt)
        assert (pc.phase_conv.dgrad_launches - before[0],
                pc.phase_conv.wgrad_launches - before[1]) == (1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dgrad_variant_of_each_main_path_shape(cuda, dtype):
    """Stride-1 main-path shapes run the forward tensor-core kernel on the
    flipped weights, packed in one launch; stride-2 ones the parity-class
    tensor-core kernel, packed in one launch too."""
    for i, shape in enumerate(SHAPES[6:]):
        x, wgt, dy = _grad_case(i, shape, getattr(torch, dtype), cuda)
        before = (pc.phase_conv.pack_launches, pc.phase_conv.launches,
                  pc.phase_conv.dgrad_launches)
        pc.phase_conv_dgrad(dy, wgt, x.shape, shape[1], shape[2])
        want = "wgmma_classes" if shape[1] == 2 else "flipped:wgmma_taps"
        assert pc.phase_conv.last_dgrad_variant == want, shape
        after = (pc.phase_conv.pack_launches, pc.phase_conv.launches,
                 pc.phase_conv.dgrad_launches)
        # the forward counter counts forward calls only
        assert tuple(b - a for a, b in zip(before, after)) == (1, 0, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_variant_of_each_main_path_shape(cuda, dtype):
    for i, shape in enumerate(SHAPES[5:]):
        x, _, dy = _grad_case(i, shape, getattr(torch, dtype), cuda)
        pc.phase_conv_wgrad(x, dy, shape[0], shape[1], shape[2])
        assert pc.phase_conv.last_wgrad_variant == "wgmma", shape


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape", SHAPES[5:])
def test_cuda_core_backward_still_matches_plain(cuda, shape, dtype, tol):
    """The CUDA-core kernels, forced on the main-path shapes: they stay
    the variant of the shapes the tensor-core predicates leave out."""
    tdt = getattr(torch, dtype)
    k, s, p = shape[:3]
    x, wgt, dy = _grad_case(4, shape, tdt, cuda, batch=2)
    dw = pc.phase_conv_wgrad(x, dy, k, s, p, _cuda_cores=True)
    assert pc.phase_conv.last_wgrad_variant == "cuda_cores"
    _assert_close_scaled(dw, pc.phase_conv_wgrad_reference(x, dy, k, s, p),
                         tol, ("wgrad", shape))
    if shape[5] != 3:
        dx = pc.phase_conv_dgrad(dy, wgt, x.shape, s, p, _cuda_cores=True)
        assert pc.phase_conv.last_dgrad_variant == "cuda_cores"
        _assert_close_scaled(
            dx, pc.phase_conv_dgrad_reference(dy, wgt, x.shape, s, p), tol,
            ("dgrad", shape))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,c,co", [(1, 64, 32), (1, 32, 32), (3, 32, 32),
                                    (1, 64, 64), (3, 32, 64), (3, 64, 128),
                                    (3, 96, 96)])
def test_pack_kernel_is_bit_equal_to_plain(cuda, k, c, co, dtype):
    """The packing kernel writes the bytes of ``_pack_taps(flipped_weights(w))``
    for the flipped taps, and of its plain version for the stride-2 classes'
    taps."""
    tdt = getattr(torch, dtype)
    w = torch.from_numpy((np.random.RandomState(k + c + co).randn(
        k, k, c, co) * 0.1).astype(np.float32)).to(cuda, tdt)
    got = pc.pack_taps(w, pc.flip_taps(k))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), pc._pack_taps(pc.flipped_weights(w)).cpu())
    taps = [ky * k + kx for _, _, ts in pc.dgrad_class_plan(k, (k - 1) // 2)
            for ky, kx, _, _ in ts]
    got = pc.pack_taps(w, taps)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), pc.pack_taps_reference(w.cpu(), taps))


@pytest.mark.gpu
def test_backward_failed_launch_raises(cuda, monkeypatch):
    """A C function that reports an error makes the wrapper raise, and so
    does an input the bulk copies cannot take; nothing falls back."""
    x, wgt, dy = _grad_case(0, SHAPES[6], torch.float32, cuda)
    k, s, p = SHAPES[6][:3]
    # the C side refuses a plan it cannot run (four warpgroups)
    part = torch.empty((1, wgt.numel()), device=cuda)
    dw = torch.empty_like(wgt)
    err = pc._kernel("wgrad_tc")(0, x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                                 part.data_ptr(), 1, 10 ** 6, 1, 4, 0, 1, 32,
                                 *x.shape, wgt.shape[3], k, s, p,
                                 *dy.shape[1:3],
                                 torch.cuda.current_stream().cuda_stream)
    assert err != 0
    for name in ("wgrad_tc", "dgrad_tc", "pack_taps"):
        with monkeypatch.context() as m:
            m.setitem(pc._fns, name, lambda *a: 1)
            with pytest.raises(RuntimeError):
                pc.phase_conv_wgrad(x, dy, k, s, p)
                pc.phase_conv_dgrad(dy, wgt, x.shape, s, p)
    with pytest.raises(ValueError):   # 16-byte alignment of the bulk copies
        xs = torch.zeros(x.numel() + 1, device=cuda)[1:].view(x.shape)
        pc.phase_conv_wgrad(xs, dy, k, s, p)


@pytest.mark.gpu
def test_autograd_function_launches_backward_kernels(cuda):
    """phase_conv under autograd: gradients of x and w against autograd
    through the plain version; a stem-like call whose input takes no
    gradient launches no dgrad; a non-contiguous dy is copied and counted."""
    shape = (3, 2, 1, 16, 12, 32, 64)
    x, wgt, dy = _grad_case(0, shape, torch.float32, cuda)
    xr, wr = x.clone().requires_grad_(), wgt.clone().requires_grad_()
    want = torch.autograd.grad(
        pc.phase_conv_reference(xr, wr, 2, 1), (xr, wr), dy)
    x.requires_grad_()
    wgt.requires_grad_()
    c0 = (pc.phase_conv.launches, pc.phase_conv.dgrad_launches,
          pc.phase_conv.wgrad_launches, pc.phase_conv.dy_copies)
    y = pc.phase_conv(x, wgt, 2, 1)
    # hand dy over as a dense NCHW tensor viewed as NHWC: one copy
    dy_nchw = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    got = torch.autograd.grad(y, (x, wgt), dy_nchw)
    for g, r, name in zip(got, want, ("dx", "dw")):
        _assert_close_scaled(g, r, 1e-4, name)
    c1 = (pc.phase_conv.launches, pc.phase_conv.dgrad_launches,
          pc.phase_conv.wgrad_launches, pc.phase_conv.dy_copies)
    assert tuple(b - a for a, b in zip(c0, c1)) == (1, 1, 1, 1)
    # the image takes no gradient: wgrad only
    img = x.detach()
    pc.phase_conv(img, wgt, 2, 1).backward(dy)
    c2 = (pc.phase_conv.launches, pc.phase_conv.dgrad_launches,
          pc.phase_conv.wgrad_launches, pc.phase_conv.dy_copies)
    assert tuple(b - a for a, b in zip(c1, c2)) == (1, 0, 1, 0)
    with pytest.raises(NotImplementedError):
        pc.phase_conv(x, wgt, 2, 1, act="silu")


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """One training step of a narrow model on the card and on the CPU from
    one state: loss, assignment-dependent metrics and every gradient."""
    from eop_tpu_torch.exp import Exp24P
    from eop_tpu_torch.losses import DWAState, Loss24PConfig, loss_24p
    from eop_tpu_torch.models.yolox import training_outputs
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    exp = Exp24P()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, 3
    imgs, labels = synthetic_24p_batch(
        torch.Generator().manual_seed(0), 2, size=128, ngt=3, r_lo=8.0,
        r_hi=30.0)
    out = {}
    for dev in ("cpu", "cuda"):
        model = exp.get_model(dev).train()
        before = (pc.phase_conv.launches, pc.phase_conv.dgrad_launches,
                  pc.phase_conv.wgrad_launches)
        heads, _ = model(imgs.to(dev).permute(0, 3, 1, 2))
        decoded, origin, grids, strides = training_outputs(heads, reg_dim=26)
        total, aux, _ = loss_24p(
            decoded, origin, labels.to(dev), grids, strides,
            DWAState.init(dev), Loss24PConfig(num_classes=3))
        total.backward()
        after = (pc.phase_conv.launches, pc.phase_conv.dgrad_launches,
                 pc.phase_conv.wgrad_launches)
        assert tuple(b - a for a, b in zip(before, after)) == (
            (8, 7, 8) if dev == "cuda" else (0, 0, 0))
        out[dev] = (total.item(), aux.num_fg_per_gt.item(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    assert out["cuda"][1] == out["cpu"][1]
    for n, g in out["cpu"][2].items():
        bound = 1e-3 * max(g.abs().max().item(), 1e-6)
        assert (out["cuda"][2][n] - g).abs().max().item() <= bound, n


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spp_pool_paths_give_equal_values_on_card(cuda, dtype):
    """SPPBottleneck pools with nn.MaxPool2d without autograd and with
    maxpool_same under it: the same forward values, bit for bit, on the card
    (ties, negative values and the -inf padding included) for the pools
    alone, and within 1e-5 for the whole block."""
    from eop_tpu_torch.ops.blocks import SPP_KERNELS, SPPBottleneck, maxpool_same

    tdt = getattr(torch, dtype)
    rng = np.random.RandomState(0)
    # coarse values force ties; 20 x 20 is the 24p-s map at 640 px
    x = torch.from_numpy(
        np.round(rng.randn(2, 16, 20, 20) * 2.0).astype(np.float32) - 3.0)
    x = x.to(cuda, tdt).contiguous(memory_format=torch.channels_last)
    for ks in SPP_KERNELS:
        want = torch.nn.functional.max_pool2d(x, ks, stride=1, padding=ks // 2)
        got = maxpool_same(x.clone().requires_grad_(), ks)
        assert got.requires_grad and torch.equal(got.detach(), want), ks
    block = SPPBottleneck(32, 32).to(cuda).eval()
    inp = torch.from_numpy(rng.randn(2, 32, 20, 20).astype(np.float32)).to(cuda)
    with torch.no_grad():
        want = block(inp)
    got = block(inp.clone().requires_grad_())
    # the convs around the pools may take another cuDNN algorithm: 1e-5
    assert got.requires_grad
    assert (got.detach() - want).abs().max().item() <= 1e-5


def _tiny_24p_exp(files, width=0.25):
    from eop_tpu_torch.exp import Exp24P

    exp = Exp24P()
    exp.depth, exp.width, exp.num_classes = 0.33, width, 3
    exp.input_size = exp.test_size = (64, 64)
    exp.data_dir, exp.label_dir = files
    return exp


@pytest.mark.gpu
def test_file_loader_feeds_pinned_batches(cuda, tmp_path, monkeypatch):
    """With a card the loader's batches come back pinned, from spawned
    workers that never touch the card, so the trainer's copy is
    asynchronous; dropped with batches in flight, as the trainer drops it,
    no worker dies (a dead one surfaces in the iterator's __del__)."""
    import sys

    from eop_tpu_torch.utils.synth import write_24p_dataset

    exp = _tiny_24p_exp(write_24p_dataset(str(tmp_path), 8, (90, 160)))
    exp.data_num_workers = 4
    unraisable = []
    monkeypatch.setattr(sys, "unraisablehook",
                        lambda u: unraisable.append(str(u.exc_value)))
    for _ in range(3):
        it = iter(exp.get_data_loader(2))
        imgs, labels, (hs, ws), ids = next(it)
        next(it)
        del it
    assert not unraisable, unraisable
    assert imgs.is_pinned() and labels.is_pinned()
    assert imgs.shape == (2, 64, 64, 3) and hs.tolist() == [90, 90]
    on_card = imgs.to(cuda, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(on_card.cpu(), imgs)


@pytest.mark.gpu
def test_oracle_ap_is_one_on_the_card(cuda, tmp_path):
    """The labels as detections on the card: AP50 = AP50:95 = 1 through the
    native COCO matcher, over a short last batch."""
    from eop_tpu_torch.eval import fast_cocoeval
    from eop_tpu_torch.utils.synth import LabelOracle, write_24p_dataset

    exp = _tiny_24p_exp(write_24p_dataset(str(tmp_path), 5, (90, 160),
                                          seed=1))
    exp.data_num_workers = 0
    ev = exp.get_evaluator(2)
    oracle = LabelOracle(ev.dataloader.dataset, cuda)

    calls = fast_cocoeval.match_image.native_calls
    ap5095, ap50, summary = ev.evaluate(oracle)
    assert abs(ap50 - 1.0) <= 1e-6 and abs(ap5095 - 1.0) <= 1e-6, summary
    assert fast_cocoeval.match_image.native_calls > calls


@pytest.mark.gpu
def test_eval_after_a_training_step_repacks_the_weights(cuda):
    """Eval, one training step, eval again in one process, at the main
    path's width: the fused eval forward packs the updated weights anew and
    folds the updated statistics, and agrees with a fresh model loaded from
    the state (1e-4 of the output scale: cuDNN may pick other algorithms for
    the other convs)."""
    from eop_tpu_torch.losses import Loss24PConfig
    from eop_tpu_torch.train.steps import create_train_state, make_train_step_24p
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    exp = _tiny_24p_exp((None, None), width=0.5)
    model = exp.get_model(cuda, seed=0)
    imgs, labels = synthetic_24p_batch(
        torch.Generator(device="cuda").manual_seed(1), 2, size=64, ngt=2,
        r_lo=5.0, r_hi=12.0)
    x = imgs.permute(0, 3, 1, 2)
    with torch.inference_mode():
        before = [h.clone() for h in model(x)[0]]
    state = create_train_state(model, exp.get_optimizer(model, 2),
                               use_ema=False, with_dwa=True)
    make_train_step_24p(Loss24PConfig(num_classes=3))(state, imgs, labels)
    model.eval()
    packs, fused = pc.packed_weights.packs, pc.phase_conv.fused_launches
    with torch.inference_mode():
        after = model(x)[0]
    assert pc.packed_weights.packs - packs == 8     # every early conv anew
    assert pc.phase_conv.fused_launches - fused == 8
    fresh = exp.get_model(cuda, seed=5)
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want = fresh(x)[0]
    for a, w, b in zip(after, want, before):
        scale = max(1.0, w.abs().max().item())
        assert (a - w).abs().max().item() <= 1e-4 * scale
        assert not torch.equal(a, b)


@pytest.mark.gpu
def test_decoder_library_matches_the_pinned_digests(cuda):
    """The host decoder built on the card's machine decodes the smoke's
    seeded 720x1280 JPEGs and PNG to the digests the CPU tests pin (where
    cv2 decodes them to the same bytes)."""
    import hashlib

    import chip_smoke
    from eop_tpu_torch.data.image_io import imdecode

    for kind, data in chip_smoke.decode_inputs().items():
        img = imdecode(data)
        assert hashlib.sha256(img.tobytes()).hexdigest() == \
            chip_smoke.DECODE_DIGESTS[kind], kind


@pytest.mark.gpu
def test_http_jpeg_body_is_200_on_the_card(cuda):
    """A JPEG body through the HTTP front end of a service on the card: 200,
    and the detections of the raw body of its decoded pixels."""
    import json
    import threading
    import urllib.request

    from eop_tpu_torch.data.image_io import imdecode
    from eop_tpu_torch.serving.http import make_http_server
    from eop_tpu_torch.serving.service import DetectionService
    from eop_tpu_torch.utils.synth import encode_jpeg

    exp = _tiny_24p_exp((None, None), width=0.5)
    exp.test_conf = 1e-5
    svc = DetectionService.from_exp(exp, exp.get_model(cuda), batch=2,
                                    src_hw=(48, 80), device=cuda,
                                    max_wait_ms=5.0)
    server = make_http_server(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/detect"
    body = encode_jpeg(np.random.RandomState(0).randint(
        0, 256, (48, 80, 3), np.uint8))
    answers = []
    try:
        for data, headers in ((body, {}), (imdecode(body).tobytes(),
                                           {"X-Raw-Shape": "48,80,3"})):
            req = urllib.request.Request(url, data=data, method="POST",
                                         headers=headers)
            with urllib.request.urlopen(req, timeout=120) as r:
                answers.append((r.status, json.loads(r.read())))
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=30)
    assert [code for code, _ in answers] == [200, 200]
    assert answers[0][1]["detections"] == answers[1][1]["detections"]
    assert answers[0][1]["image_hw"] == [48, 80]


@pytest.mark.gpu
def test_async_front_end_answers_as_the_threaded_one_on_the_card(cuda):
    """The event-loop and the threaded front end over one service on the
    card's 24p serving function: the same detections for the same frames
    (each posted alone, so each is a batch of its own in both), and
    ``phase_conv`` launched 8 times a device call."""
    import http.client
    import json
    import threading

    from eop_tpu_torch.serving.http import make_http_server
    from eop_tpu_torch.serving.http_async import make_async_http_server
    from eop_tpu_torch.serving.service import DetectionService

    exp = _tiny_24p_exp((None, None), width=0.5)
    exp.test_conf = 1e-5
    launches = pc.phase_conv.launches
    svc = DetectionService.from_exp(exp, exp.get_model(cuda), batch=2,
                                    src_hw=(48, 80), device=cuda,
                                    max_wait_ms=5.0)
    calls = svc.stats()["device_calls"]
    frames = np.random.RandomState(0).randint(0, 256, (4, 48, 80, 3),
                                              np.uint8)
    answers = {}
    try:
        for name, make in (("async", make_async_http_server),
                           ("threaded", make_http_server)):
            server = make(svc, host="127.0.0.1", port=0)
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.server_address[1], timeout=120)
            try:
                for frame in frames:
                    conn.request("POST", "/v1/detect", body=frame.tobytes(),
                                 headers={"X-Raw-Shape": "48,80,3"})
                    r = conn.getresponse()
                    answers.setdefault(name, []).append(
                        (r.status, json.loads(r.read())["detections"]))
            finally:
                conn.close()
                server.shutdown()
                thread.join(timeout=30)
                if name == "threaded":
                    server.server_close()
            assert not thread.is_alive()
        torch.cuda.synchronize()
        calls = svc.stats()["device_calls"] - calls
    finally:
        svc.close()
    assert [c for c, _ in answers["async"]] == [200] * len(frames)
    assert answers["async"] == answers["threaded"]
    assert sum(len(d) for _, d in answers["async"]) > 0
    assert calls == 2 * len(frames)
    # the warmup's calls (one a bucket) and the requests', 8 launches each
    assert pc.phase_conv.launches - launches == 8 * (calls + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["relu", "lrelu"])
def test_non_silu_model_launches_phase_conv_unfused(cuda, act):
    """An ``act`` the kernel's epilogue lacks: the 8 early convs still launch
    the kernel, without the epilogue, and the heads agree with the CPU's."""
    exp = _tiny_24p_exp((None, None), width=0.5)
    exp.act = act
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        0, 255, (2, 3, 64, 64)).astype(np.float32))
    model, plain = exp.get_model(cuda, seed=2), exp.get_model("cpu", seed=2)
    launches, fused = pc.phase_conv.launches, pc.phase_conv.fused_launches
    with torch.inference_mode():
        got = model(x.to(cuda))[0]
    torch.cuda.synchronize()
    assert pc.phase_conv.launches - launches == 8
    assert pc.phase_conv.fused_launches == fused
    with torch.inference_mode():
        want = plain(x)[0]
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        assert (g.cpu() - w).abs().max().item() <= 1e-3 * scale


# ---- bf16 compute and remat (compute_dtype, remat) ----

def _bf16_exp(remat=False):
    from eop_tpu_torch.exp import Exp24P

    exp = Exp24P()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, 3
    exp.compute_dtype, exp.remat = "bfloat16", remat
    return exp


@pytest.mark.gpu
def test_bf16_serving_on_card_matches_cpu(cuda):
    """bf16 24p model, eval mode: 8 fused launches on the tensor-core
    variants, bf16 head maps within 5e-2 of their scale of the CPU's bf16
    path (the two round at other points), and detections from both."""
    exp = _bf16_exp()
    exp.test_size, exp.test_conf = (128, 128), 1e-5
    raw = np.random.RandomState(0).randint(0, 256, (2, 128, 128, 3), np.uint8)
    heads, dets = {}, {}
    for dev in ("cpu", "cuda"):
        model = exp.get_model(dev)
        before = (pc.phase_conv.launches, pc.phase_conv.fused_launches)
        with torch.inference_mode():
            out, _ = model(torch.from_numpy(raw).to(dev).float().permute(
                0, 3, 1, 2))
        heads[dev] = [o.float().cpu() for o in out]
        launched = (pc.phase_conv.launches - before[0],
                    pc.phase_conv.fused_launches - before[1])
        assert launched == ((8, 8) if dev == "cuda" else (0, 0))
        assert {o.dtype for o in out} == {torch.bfloat16}
        dets[dev] = exp.get_serving_fn(model, (128, 128), dev)(raw)
    assert pc.phase_conv.last_variant == "wgmma_taps"
    for g, c in zip(heads["cuda"], heads["cpu"]):
        assert (g - c).abs().max().item() <= 5e-2 * c.abs().max().item()
    assert int(dets["cuda"].valid.sum()) > 0 and int(dets["cpu"].valid.sum()) > 0


def _one_step(exp, dev, imgs, labels):
    """One training step through make_train_step_24p: the loss, the
    gradients, the buffers after it and the kernels' launches."""
    from eop_tpu_torch.losses import Loss24PConfig
    from eop_tpu_torch.train.steps import create_train_state, make_train_step_24p

    model = exp.get_model(dev, seed=0)
    state = create_train_state(model, exp.get_optimizer(model, 2, lr=0.01),
                               use_ema=False, with_dwa=True)
    before = (pc.phase_conv.launches, pc.phase_conv.wgrad_launches,
              pc.phase_conv.dgrad_launches)
    _, metrics = make_train_step_24p(Loss24PConfig(num_classes=3))(
        state, imgs.to(dev), labels.to(dev))
    after = (pc.phase_conv.launches, pc.phase_conv.wgrad_launches,
             pc.phase_conv.dgrad_launches)
    return (metrics["total_loss"].item(),
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: b.cpu() for n, b in model.named_buffers()},
            tuple(b - a for a, b in zip(before, after)))


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_bf16_train_step_on_card_matches_cpu(cuda, remat):
    """A bf16 training step on the card and on the CPU from one state:
    launches 8/8/7 (forward/wgrad/dgrad; 16 forward under remat: the
    recompute; at width 0.25 the 16-channel convs take the CUDA-core
    backward, which packs nothing), the loss within 5e-2 (bf16 rounding and
    SimOTA's discrete assignment, tests/test_torch_bf16.py), fp32 finite
    gradients."""
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    imgs, labels = synthetic_24p_batch(
        torch.Generator().manual_seed(0), 2, size=128, ngt=3, r_lo=8.0,
        r_hi=30.0)
    exp = _bf16_exp(remat)
    cpu = _one_step(exp, "cpu", imgs, labels)
    card = _one_step(exp, cuda, imgs, labels)
    assert cpu[3] == (0, 0, 0)
    assert card[3] == (16 if remat else 8, 8, 7)
    assert abs(card[0] - cpu[0]) <= 5e-2 * abs(cpu[0])
    for n, g in card[1].items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), n


@pytest.mark.gpu
def test_remat_on_card_updates_batchnorm_once(cuda):
    """One bf16 step with and without remat from one state on the card: the
    BatchNorm running statistics equal, num_batches_tracked 1 in every
    BatchNorm."""
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    imgs, labels = synthetic_24p_batch(
        torch.Generator().manual_seed(1), 2, size=128, ngt=3, r_lo=8.0,
        r_hi=30.0)
    plain = _one_step(_bf16_exp(False), cuda, imgs, labels)[2]
    remat = _one_step(_bf16_exp(True), cuda, imgs, labels)[2]
    for n, b in plain.items():
        if n.endswith("num_batches_tracked"):
            assert int(b) == int(remat[n]) == 1, n
        else:
            bound = 1e-6 * max(b.abs().max().item(), 1e-30)
            assert (remat[n] - b).abs().max().item() <= bound, n


# --- the bbox family (YOLOX-S..X by name; YOLOX-L at full width)

# the 12 convs of YOLOX-L that run phase_conv at 1/5 of 640 px, with the
# forward, weight-gradient and data-gradient variant each takes at 640 px
# (None: the stem has no data gradient)
YOLOX_L_SHAPES = (
    [((6, 2, 2, 128, 128, 3, 64), "wgmma_rows", "wgmma", None),
     ((3, 2, 1, 64, 64, 64, 128), "wgmma_taps", "wgmma", "wgmma_classes")]
    + [((1, 1, 0, 32, 32, 128, 64), "wgmma_taps", "wgmma",
        "flipped:wgmma_taps")] * 2
    + [((k, 1, k // 2, 32, 32, 64, 64), "wgmma_taps", "wgmma",
        "flipped:wgmma_taps") for _ in range(3) for k in (1, 3)]
    + [((1, 1, 0, 32, 32, 128, 128), "wgmma_taps", "wgmma",
        "flipped:wgmma_taps"),
       ((3, 2, 1, 32, 32, 128, 256), "wgmma_taps", "wgmma",
        "wgmma_classes")])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_yolox_l_shapes_take_their_variants(cuda, dtype, tol):
    """The YOLOX-L early convs: forward (with and without the fused
    epilogue), weight and data gradient against their plain versions, each
    on the variant the 640 px path takes (every forward and weight gradient
    on the tensor cores: the stem on wgmma_rows, dark3's down conv in two N
    tiles)."""
    tdt = getattr(torch, dtype)
    for i, (shape, fwd, wg, dg) in enumerate(YOLOX_L_SHAPES):
        k, s, p, h, w, c, co = shape
        x, wgt, scale, shift = _case(i, shape, tdt, cuda)
        _assert_kernel_matches_plain(x, wgt, s, p, tol)
        assert pc.phase_conv.last_variant == fwd, shape
        _assert_kernel_matches_plain(x, wgt, s, p, tol, scale=scale,
                                     shift=shift, act="silu")
        ho, wo = pc.out_hw(h, w, k, s, p)
        dy = torch.randn((2, ho, wo, co), device=cuda).to(tdt)
        for got, want, what in (
                (pc.phase_conv_wgrad(x, dy, k, s, p),
                 pc.phase_conv_wgrad_reference(x, dy, k, s, p), "wgrad"),
                (pc.phase_conv_dgrad(dy, wgt, x.shape, s, p),
                 pc.phase_conv_dgrad_reference(dy, wgt, x.shape, s, p),
                 "dgrad")):
            bound = tol * max(1.0, want.float().abs().max().item())
            err = (got.float() - want.float()).abs().max().item()
            assert err <= bound, (shape, what, err, bound)
        assert pc.phase_conv.last_wgrad_variant == wg, shape
        if dg is not None:
            assert pc.phase_conv.last_dgrad_variant == dg, shape


@pytest.mark.gpu
def test_bbox_train_step_on_card_matches_cpu(cuda):
    """One YOLOX bbox training step (depth 0.33, width 0.25, 3 classes, 128
    px, B=2) from one state on the card and on the CPU: the same
    foreground count, the loss within 1e-4, every gradient within 1e-3 of
    its largest value; 8 / 8 / 7 launches (forward / wgrad / dgrad)."""
    from eop_tpu_torch.exp import Exp
    from eop_tpu_torch.losses import YoloxLossConfig
    from eop_tpu_torch.train.steps import create_train_state, \
        make_train_step_bbox

    exp = Exp()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, 3
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.uniform(0, 255, (2, 128, 128, 3)).astype(
        np.float32))
    labels = torch.zeros((2, 50, 5))
    for b in range(2):
        for g in range(4):
            w, h = rng.uniform(12, 50, 2)
            labels[b, g] = torch.tensor([rng.randint(3), rng.uniform(w, 128 - w),
                                         rng.uniform(h, 128 - h), w, h])
    out = {}
    for dev in ("cpu", cuda):
        model = exp.get_model(dev, seed=0).train()
        state = create_train_state(model, exp.get_optimizer(model, 2, 1))
        before = (pc.phase_conv.launches, pc.phase_conv.wgrad_launches,
                  pc.phase_conv.dgrad_launches)
        grads = {}

        def hook(name, metrics=None):
            if name == "backward":
                grads.update({n: p.grad.cpu()
                              for n, p in model.named_parameters()})

        step = make_train_step_bbox(YoloxLossConfig(num_classes=3), hook=hook)
        _, metrics = step(state, imgs.to(dev), labels.to(dev))
        after = (pc.phase_conv.launches, pc.phase_conv.wgrad_launches,
                 pc.phase_conv.dgrad_launches)
        out[str(dev)] = (metrics, grads,
                         tuple(b - a for a, b in zip(before, after)))
    (m_cpu, g_cpu, n_cpu), (m_gpu, g_gpu, n_gpu) = out["cpu"], out["cuda"]
    assert n_cpu == (0, 0, 0) and n_gpu == (8, 8, 7)
    assert m_gpu["num_fg"].item() == m_cpu["num_fg"].item()
    assert abs(m_gpu["total_loss"].item() - m_cpu["total_loss"].item()) <= \
        1e-4 * abs(m_cpu["total_loss"].item())
    for n, g in g_cpu.items():
        bound = 1e-3 * max(g.abs().max().item(), 1e-12)
        assert (g_gpu[n] - g).abs().max().item() <= bound, n


# ---- YOLOX-Nano, YOLOX-Tiny, YOLOv3 and bbox serving ----

# (shape, forward, wgrad, dgrad variant): each new early-conv shape at a
# tenth of its size (Tiny 640 / 416 px, Nano 416 px, YOLOv3 640 px); the
# channel counts decide the variants (and Nano's stem at 42 px, a row of no
# 16-byte multiple, the CUDA cores; its 16- and 32-channel 1x1 convs both
# ways small_1x1; the stems' 3 input channels keep their data gradient on
# the CUDA cores)
ZOO_SHAPES = [
    ((6, 2, 2, 42, 42, 3, 16), "direct", "cuda_cores", "cuda_cores"),
    ((1, 1, 0, 10, 10, 16, 32), "small_1x1", "wgmma", "small_1x1"),
    ((1, 1, 0, 10, 10, 32, 16), "small_1x1", "wgmma", "small_1x1"),
    ((1, 1, 0, 6, 6, 32, 64), "wgmma_taps", "wgmma", "flipped:wgmma_taps"),
    ((6, 2, 2, 64, 64, 3, 24), "wgmma_rows", "wgmma", "cuda_cores"),
    ((3, 2, 1, 32, 32, 24, 48), "wgmma_taps", "wgmma", "wgmma_classes"),
    ((3, 1, 1, 16, 16, 24, 24), "wgmma_taps", "wgmma", "flipped:wgmma_taps"),
    ((3, 2, 1, 16, 16, 48, 96), "wgmma_taps", "wgmma", "wgmma_classes"),
    ((3, 1, 1, 64, 64, 3, 32), "wgmma_rows", "wgmma", "cuda_cores"),
    ((3, 2, 1, 64, 64, 32, 64), "wgmma_taps", "wgmma", "wgmma_classes"),
    ((3, 2, 1, 16, 16, 128, 256), "wgmma_taps", "wgmma", "wgmma_classes"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_zoo_shapes_take_their_variants(cuda, dtype, tol):
    """Nano's, Tiny's and YOLOv3's early convs: forward (with and without
    the fused epilogue), weight and data gradient against their plain
    versions, each on the variant its channels give."""
    tdt = getattr(torch, dtype)
    for i, (shape, fwd, wg, dg) in enumerate(ZOO_SHAPES):
        k, s, p, h, w, c, co = shape
        x, wgt, scale, shift = _case(i, shape, tdt, cuda)
        _assert_kernel_matches_plain(x, wgt, s, p, tol)
        assert pc.phase_conv.last_variant == fwd, shape
        _assert_kernel_matches_plain(x, wgt, s, p, tol, scale=scale,
                                     shift=shift, act="silu")
        ho, wo = pc.out_hw(h, w, k, s, p)
        dy = torch.randn((2, ho, wo, co), device=cuda).to(tdt)
        for got, want, what in (
                (pc.phase_conv_wgrad(x, dy, k, s, p),
                 pc.phase_conv_wgrad_reference(x, dy, k, s, p), "wgrad"),
                (pc.phase_conv_dgrad(dy, wgt, x.shape, s, p),
                 pc.phase_conv_dgrad_reference(dy, wgt, x.shape, s, p),
                 "dgrad")):
            bound = tol * max(1.0, want.float().abs().max().item())
            err = (got.float() - want.float()).abs().max().item()
            assert err <= bound, (shape, what, err, bound)
        assert pc.phase_conv.last_wgrad_variant == wg, shape
        assert pc.phase_conv.last_dgrad_variant == dg, shape


# (shape, forward, wgrad variant): the shape families the widened tensor-core
# predicates take, at a tenth of their size: the stems on 3 channels
# (Nano's at 48 px, M's, X's), zero-filled channel runs (C 24, 48, 80,
# 160), N tiles with a masked tail (Co 24, 40, 48, 80, 160, 192, 320), M
# parts of a ky (C 80 and 160 at 3x3); the data gradients of all but the
# stems on the tensor cores (DGRAD_WIDE_SHAPES holds them apart)
WIDE_SHAPES = [
    ((6, 2, 2, 48, 48, 3, 16), "wgmma_rows", "wgmma"),
    ((6, 2, 2, 64, 64, 3, 48), "wgmma_rows", "wgmma"),
    ((6, 2, 2, 64, 64, 3, 80), "wgmma_rows", "wgmma"),
    ((1, 1, 0, 16, 16, 24, 24), "wgmma_taps", "wgmma"),
    ((3, 2, 1, 32, 32, 48, 96), "wgmma_taps", "wgmma"),
    ((1, 1, 0, 16, 16, 96, 48), "wgmma_taps", "wgmma"),
    ((3, 1, 1, 16, 16, 48, 48), "wgmma_taps", "wgmma"),
    ((3, 2, 1, 16, 16, 96, 192), "wgmma_taps", "wgmma"),
    ((3, 2, 1, 32, 32, 80, 160), "wgmma_taps", "wgmma"),
    ((1, 1, 0, 16, 16, 160, 80), "wgmma_taps", "wgmma"),
    ((3, 1, 1, 16, 16, 80, 80), "wgmma_taps", "wgmma"),
    ((1, 1, 0, 16, 16, 160, 160), "wgmma_taps", "wgmma"),
    ((3, 2, 1, 16, 16, 160, 320), "wgmma_taps", "wgmma"),
    ((3, 2, 1, 18, 22, 24, 40), "wgmma_taps", "wgmma"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_wide_shapes_take_the_tensor_cores(cuda, dtype, tol):
    """Every shape family the widened tensor-core predicates take: the
    forward (with and without the fused epilogue) and the weight gradient
    on their tensor-core variants within ``tol`` of their plain versions,
    the weight gradient the same bits twice; the data gradient on the
    variant of its predicate, within ``tol``."""
    tdt = getattr(torch, dtype)
    for i, (shape, fwd, wg) in enumerate(WIDE_SHAPES):
        k, s, p, h, w, c, co = shape
        x, wgt, scale, shift = _case(i, shape, tdt, cuda)
        _assert_kernel_matches_plain(x, wgt, s, p, tol)
        assert pc.phase_conv.last_variant == fwd, shape
        _assert_kernel_matches_plain(x, wgt, s, p, tol, scale=scale,
                                     shift=shift, act="silu")
        assert pc.phase_conv.last_variant == fwd, shape
        ho, wo = pc.out_hw(h, w, k, s, p)
        dy = torch.randn((2, ho, wo, co), device=cuda).to(tdt)
        dw = pc.phase_conv_wgrad(x, dy, k, s, p)
        assert pc.phase_conv.last_wgrad_variant == wg, shape
        assert torch.equal(dw, pc.phase_conv_wgrad(x, dy, k, s, p)), shape
        _assert_close_scaled(dw, pc.phase_conv_wgrad_reference(
            x, dy, k, s, p), tol, ("wgrad", shape))
        if c != 3:
            dx = pc.phase_conv_dgrad(dy, wgt, x.shape, s, p)
            assert pc.phase_conv.last_dgrad_variant == pc.dgrad_variant(
                dy.shape, wgt.shape, s, p, tdt)
            _assert_close_scaled(dx, pc.phase_conv_dgrad_reference(
                dy, wgt, x.shape, s, p), tol, ("dgrad", shape))


# the data gradients that left the CUDA cores, at a tenth of their size or
# less: Nano's 1x1 16/32-channel ones (small_1x1 since it exists; their
# flipped route, forced, still compared), Tiny's, M's and X's (one N tile of 32
# over C = 24, of 96 over C = 80, two of 96 over C = 160; K runs of 32 over
# Co = 24, 80, 160 and, in bf16, of 64 over Co = 48), a 1x1/s2 with classes
# no tap reaches and ragged class tiles
DGRAD_WIDE_SHAPES = [
    (1, 1, 0, 20, 20, 16, 32),
    (1, 1, 0, 20, 20, 32, 16),
    (1, 1, 0, 20, 20, 16, 16),
    (3, 2, 1, 32, 32, 24, 48),
    (1, 1, 0, 16, 16, 48, 24),
    (3, 1, 1, 16, 16, 24, 24),
    (3, 2, 1, 16, 16, 48, 96),
    (1, 1, 0, 16, 16, 96, 48),
    (3, 1, 1, 16, 16, 48, 48),
    (3, 2, 1, 16, 16, 96, 192),
    (3, 2, 1, 32, 32, 80, 160),
    (1, 1, 0, 16, 16, 160, 80),
    (3, 1, 1, 16, 16, 80, 80),
    (3, 2, 1, 16, 16, 160, 320),
    (1, 2, 0, 8, 6, 16, 24),
    (3, 2, 1, 18, 22, 24, 40),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape", DGRAD_WIDE_SHAPES)
def test_wide_data_gradients_take_the_tensor_cores(cuda, shape, dtype, tol):
    """Each widened data gradient on ``flipped:wgmma_taps`` (stride 1) or
    ``wgmma_classes`` (stride 2), Nano's small 1x1s on ``small_1x1``:
    within ``tol`` of its plain version and of the CUDA-core kernel forced
    on the same inputs, the same bits twice, one packing (none on
    ``small_1x1``) and one data-gradient launch a call by variant and no
    forward launch counted; the packing kernel's bytes those of
    ``pack_taps_reference``."""
    tdt = getattr(torch, dtype)
    k, s, p = shape[:3]
    x, wgt, dy = _grad_case(3, shape, tdt, cuda)
    small = pc.small_1x1_fits(k, s, shape[5], shape[6])
    want = ("small_1x1" if small else "flipped:wgmma_taps" if s == 1
            else "wgmma_classes")
    assert pc.dgrad_variant(dy.shape, wgt.shape, s, p, tdt) == want
    before = (dict(pc.phase_conv.dgrad_variant_launches),
              pc.phase_conv.pack_launches, pc.phase_conv.launches)
    dx = pc.phase_conv_dgrad(dy, wgt, x.shape, s, p)
    dx2 = pc.phase_conv_dgrad(dy, wgt, x.shape, s, p)
    torch.cuda.synchronize()
    after = (pc.phase_conv.dgrad_variant_launches,
             pc.phase_conv.pack_launches, pc.phase_conv.launches)
    assert pc.phase_conv.last_dgrad_variant == want
    assert {v: n - before[0].get(v, 0) for v, n in after[0].items()
            if n != before[0].get(v, 0)} == {want: 2}
    assert (after[1] - before[1], after[2] - before[2]) == (
        0 if small else 2, 0)
    assert torch.equal(dx, dx2), shape
    _assert_close_scaled(dx, pc.phase_conv_dgrad_reference(
        dy, wgt, x.shape, s, p), tol, ("dgrad", shape))
    old = pc.phase_conv_dgrad(dy, wgt, x.shape, s, p, _cuda_cores=True)
    assert pc.phase_conv.last_dgrad_variant == "cuda_cores"
    _assert_close_scaled(dx, old, tol, ("dgrad vs cuda_cores", shape))
    if small:   # the route small_1x1 replaced, forced
        flipped = pc.phase_conv_dgrad(dy, wgt, x.shape, s, p, _flipped=True)
        assert pc.phase_conv.last_dgrad_variant == "flipped:wgmma_taps"
        _assert_close_scaled(dx, flipped, tol, ("dgrad vs flipped", shape))
    taps = (pc.flip_taps(k) if s == 1 else
            [ky * k + kx for _, _, ts in pc.dgrad_class_plan(k, p)
             for ky, kx, _, _ in ts])
    got = pc.pack_taps(wgt, taps)
    torch.cuda.synchronize()
    assert tuple(got.shape) == pc.pack_taps_shape(len(taps), shape[5],
                                                  shape[6], tdt)
    assert torch.equal(got.cpu(), pc.pack_taps_reference(wgt.cpu(), taps))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["yolox-m", "yolox-x"])
def test_yolox_m_and_x_forward_on_card_matches_cpu(cuda, name):
    """YOLOX-M and YOLOX-X by name (every early conv on the tensor cores)
    at B=1, 128 px: the head maps on the card within 1e-3 of the CPU's
    scale; 10 and 14 launches, the stem's on wgmma_rows, none on direct."""
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(exp_name=name)
    x = torch.from_numpy(np.random.RandomState(5).uniform(
        0, 255, (1, 3, 128, 128)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        model = exp.get_model(dev, seed=1).eval()
        before = dict(pc.phase_conv.variant_launches)
        with torch.no_grad():
            heads, _ = model(x.to(dev))
        torch.cuda.synchronize()
        maps = torch.cat([h.float().cpu().flatten() for h in heads])
        out[str(dev)] = (maps, {
            v: n - before.get(v, 0)
            for v, n in pc.phase_conv.variant_launches.items()})
    (h_cpu, n_cpu), (h_gpu, n_gpu) = out["cpu"], out["cuda"]
    convs = {"yolox-m": 10, "yolox-x": 14}[name]
    assert not any(n_cpu.values())
    assert (n_gpu.get("wgmma_rows"), n_gpu.get("wgmma_taps"),
            n_gpu.get("direct", 0)) == (1, convs - 1, 0)
    bound = 1e-3 * max(1.0, h_cpu.abs().max().item())
    assert (h_gpu - h_cpu).abs().max().item() <= bound


def _zoo_exp(kind):
    from eop_tpu_torch.exp import Exp

    exp = Exp()
    exp.num_classes, exp.test_size, exp.test_conf = 3, (64, 64), 1e-5
    if kind == "nano":
        exp.depth, exp.width, exp.depthwise = 0.33, 0.25, True
    else:
        exp.model_kind = "yolov3"
    return exp


@pytest.mark.gpu
@pytest.mark.parametrize("kind,launches,fused", [("nano", 8, 8),
                                                 ("yolov3", 10, 0)])
def test_zoo_serving_on_card_matches_cpu(cuda, kind, launches, fused):
    """The bbox serving function of Nano (DWConv: the pconvs take the
    kernel, fused) and of YOLOv3 (lrelu: unfused) on the card against the
    CPU at a canvas other than test_size: the same detections, each box
    within 1e-2 px of one of the CPU's of its class (seeded weights score
    every anchor near the 1e-4 prior, so near-equal scores may take
    another order).  The box-regression weights are scaled by 1e-2 on both
    devices: at seeded weights YOLOv3's lrelu trunk gives raw regressions
    near 60, boxes e^60 strides wide, which would hold only saturated
    exponentials to the bound; scaled, every box lies within the canvas's
    reach."""
    exp = _zoo_exp(kind)
    raw = np.random.RandomState(4).randint(0, 256, (2, 48, 80, 3), np.uint8)
    out = {}
    for dev in ("cpu", cuda):
        model = exp.get_model(dev, seed=3)
        with torch.no_grad():
            for p in model.head.reg_preds:
                p.weight.mul_(1e-2)
        before = (pc.phase_conv.launches, pc.phase_conv.fused_launches)
        dets = exp.get_serving_fn(model, (48, 80), dev)(raw)
        torch.cuda.synchronize()
        out[str(dev)] = (dets.rows.cpu(), dets.valid.cpu(),
                         pc.phase_conv.launches - before[0],
                         pc.phase_conv.fused_launches - before[1])
    rows_c, valid_c, n_c, _ = out["cpu"]
    rows_g, valid_g, n_g, f_g = out["cuda"]
    assert n_c == 0 and (n_g, f_g) == (launches, fused)
    assert torch.equal(valid_c, valid_g) and valid_c.sum() > 0
    assert rows_c[valid_c][:, :4].abs().max().item() <= 4 * 80
    for b in range(rows_c.shape[0]):
        got, want = rows_g[b][valid_g[b]], rows_c[b][valid_c[b]]
        dist = (got[:, None, :4] - want[None, :, :4]).abs().amax(dim=-1)
        dist[got[:, None, 6] != want[None, :, 6]] = float("inf")
        assert dist.amin(dim=1).max().item() <= 1e-2
        assert dist.amin(dim=0).max().item() <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("kind,name", [("nano", "yolox-nano"),
                                       ("yolov3", "yolov3")])
def test_zoo_train_step_on_card_matches_cpu(cuda, kind, name):
    """One bbox step of Nano and of YOLOv3 (128 px, B=2) on the card and on
    the CPU from one state: the same foreground count, the loss within
    1e-4; launches forward / wgrad / dgrad / packing as the smoke's table
    of each conv's variants gives them."""
    import chip_smoke
    from eop_tpu_torch.losses import YoloxLossConfig
    from eop_tpu_torch.train.steps import create_train_state, \
        make_train_step_bbox

    exp = _zoo_exp(kind)
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.uniform(0, 255, (2, 128, 128, 3)).astype(
        np.float32))
    labels = torch.zeros((2, 50, 5))
    for b in range(2):
        for g in range(4):
            w, h = rng.uniform(12, 50, 2)
            labels[b, g] = torch.tensor([rng.randint(3),
                                         rng.uniform(w, 128 - w),
                                         rng.uniform(h, 128 - h), w, h])
    counters = ("launches", "wgrad_launches", "dgrad_launches",
                "pack_launches")
    out = {}
    for dev in ("cpu", cuda):
        model = exp.get_model(dev, seed=0).train()
        state = create_train_state(model, exp.get_optimizer(model, 2, 1))
        before = [getattr(pc.phase_conv, c) for c in counters]
        step = make_train_step_bbox(YoloxLossConfig(num_classes=3))
        _, metrics = step(state, imgs.to(dev), labels.to(dev))
        torch.cuda.synchronize()
        out[str(dev)] = (metrics, tuple(getattr(pc.phase_conv, c) - b
                                        for c, b in zip(counters, before)))
    (m_cpu, n_cpu), (m_gpu, n_gpu) = out["cpu"], out["cuda"]
    want = chip_smoke.step_launches(name)
    assert n_cpu == (0, 0, 0, 0)
    assert n_gpu == tuple(want[k] for k in ("forward", "wgrad", "dgrad",
                                            "pack"))
    if kind == "nano":   # the five small 1x1s both ways on small_1x1
        assert n_gpu == (8, 8, 7, 2)
        assert (want["forward:small_1x1"], want["dgrad:small_1x1"]) == (5, 5)
    assert m_gpu["num_fg"].item() == m_cpu["num_fg"].item() > 0
    assert abs(m_gpu["total_loss"].item() - m_cpu["total_loss"].item()) <= \
        1e-4 * abs(m_cpu["total_loss"].item())


# ---- small_1x1 (YOLOX-Nano's 16- and 32-channel 1x1 convs) and the stems'
# N tiles (YOLOX-X at 800 px) ----

# (H, W, C, Co) at batch 3: M = 3 * H * W pixels, ragged against the
# kernel's 256-pixel tiles; every N of the kernel and both ends of K
SMALL_1X1_SHAPES = [
    (13, 13, 16, 32), (13, 13, 32, 16), (7, 9, 16, 16), (1, 5, 8, 64),
    (11, 3, 64, 8), (20, 20, 24, 16), (9, 9, 8, 40), (5, 17, 8, 56),
    (104, 104, 16, 32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape", SMALL_1X1_SHAPES)
def test_small_1x1_matches_plain(cuda, shape, dtype, tol):
    """``small_1x1`` forward (with and without the fused epilogue) and data
    gradient (the weights read transposed) within ``tol`` of their plain
    versions relative to the output scale at ragged M, the same bits on two
    launches; one launch a call on each counter by variant, no packing."""
    h, w, c, co = shape
    tdt = getattr(torch, dtype)
    case = (1, 1, 0, h, w, c, co)
    x, wgt, scale, shift = _case(11, case, tdt, cuda, batch=3)
    _, _, dy = _grad_case(12, case, tdt, cuda, batch=3)
    before = (dict(pc.phase_conv.variant_launches),
              dict(pc.phase_conv.dgrad_variant_launches),
              pc.phase_conv.pack_launches)
    for kw in ({}, {"scale": scale, "shift": shift, "act": "silu"},
               {"act": "silu"}):
        got = pc.phase_conv(x, wgt, 1, 0, **kw)
        assert pc.phase_conv.last_variant == "small_1x1"
        assert torch.equal(got, pc.phase_conv(x, wgt, 1, 0, **kw))
        _assert_close_scaled(got, pc.phase_conv_reference(x, wgt, 1, 0, **kw),
                             tol, ("forward", shape, tuple(kw)))
    dx = pc.phase_conv_dgrad(dy, wgt, x.shape, 1, 0)
    assert pc.phase_conv.last_dgrad_variant == "small_1x1"
    assert torch.equal(dx, pc.phase_conv_dgrad(dy, wgt, x.shape, 1, 0))
    _assert_close_scaled(dx, pc.phase_conv_dgrad_reference(
        dy, wgt, x.shape, 1, 0), tol, ("dgrad", shape))
    assert (pc.phase_conv.variant_launches["small_1x1"]
            - before[0].get("small_1x1", 0)) == 6
    assert (pc.phase_conv.dgrad_variant_launches["small_1x1"]
            - before[1].get("small_1x1", 0)) == 2
    assert pc.phase_conv.pack_launches == before[2]
    # the CUDA-core direct kernel it replaced, forced, agrees
    _assert_close_scaled(got, pc.phase_conv(x, wgt, 1, 0, _direct=True,
                                            act="silu"), tol, ("direct",))


@pytest.mark.gpu
def test_small_1x1_failed_launch_raises(cuda, monkeypatch):
    """A C function that reports an error makes both wrappers raise; the C
    side refuses what it does not take; nothing falls back."""
    x, wgt, _, _ = _case(0, (1, 1, 0, 8, 8, 16, 32), torch.float32, cuda)
    y = torch.empty((2, 8, 8, 32), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for k_in, n_out in ((16, 64), (12, 16), (72, 8)):   # K * N > 512, K % 8
        assert pc._kernel("small_1x1")(0, x.data_ptr(), wgt.data_ptr(),
                                       y.data_ptr(), None, None, 0, 128, k_in,
                                       n_out, 0, stream) != 0
    with monkeypatch.context() as m:
        m.setitem(pc._fns, "small_1x1", lambda *a: 1)
        with pytest.raises(RuntimeError):
            pc.phase_conv(x, wgt, 1, 0)
        with pytest.raises(RuntimeError):
            pc.phase_conv_dgrad(y, wgt, x.shape, 1, 0)
    with pytest.raises(ValueError):   # 16-byte alignment of the bulk copy
        xs = torch.zeros(x.numel() + 1, device=cuda)[1:].view(x.shape)
        pc.phase_conv(xs, wgt, 1, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("size,tile", [(800, (64, 2)), (1152, (32, 3))])
def test_wide_stem_takes_wgmma_rows_in_n_tiles(cuda, size, tile):
    """YOLOX-X's fp32 stem (6x6/s2, 3 -> 80) at 800 px (the top of its
    multiscale range: two N tiles of 64) and at 1152 px (three of 32) on
    ``wgmma_rows`` within 1e-4 of its plain version, with and without the
    epilogue, and of the ``direct`` kernel forced; bf16 at 800 px within
    1e-2 on one tile of 96."""
    shape = (6, 2, 2, size, size, 3, 80)
    x, wgt, scale, shift = _case(5, shape, torch.float32, cuda, batch=1)
    assert pc.rows_tile(size, 80, 6, torch.float32) == tile
    for kw in ({}, {"scale": scale, "shift": shift, "act": "silu"}):
        _assert_kernel_matches_plain(x, wgt, 2, 2, 1e-4, **kw)
        assert pc.phase_conv.last_variant == "wgmma_rows"
    _assert_close_scaled(pc.phase_conv(x, wgt, 2, 2), pc.phase_conv(
        x, wgt, 2, 2, _direct=True), 1e-4, ("direct", size))
    assert pc.phase_conv.last_variant == "direct"
    if size == 800:
        _assert_kernel_matches_plain(x.bfloat16(), wgt.bfloat16(), 2, 2, 1e-2)
        assert pc.phase_conv.last_variant == "wgmma_rows"
        assert pc.rows_tile(size, 80, 6, torch.bfloat16) == (96, 1)


# ---- the feature-map study's backbones and demo ----

@pytest.mark.gpu
@pytest.mark.parametrize("backbone", ["vgg", "resnet", "densenet"])
def test_backbone_on_card_matches_cpu(cuda, backbone):
    """YOLOX over VGG19 / ResNet50 / DenseNet121 (their fixed 256 / 512 /
    1024 taps under a width-0.25 neck), eval mode, 64 px, B=2: the 6-tuple
    and the head maps on the card within 1e-3 of the CPU's (relative to each
    output's scale); no phase_conv launch (the backbones are F.conv2d)."""
    from eop_tpu_torch.exp import Exp

    exp = Exp()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, 3
    exp.backbone_type = backbone
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 255, (2, 64, 64, 3)).astype(np.float32)).permute(0, 3, 1, 2)
    outs = {}
    before = pc.phase_conv.launches
    for dev in ("cpu", "cuda"):
        model = exp.get_model(dev)
        with torch.inference_mode():
            heads, fpn = model(x.to(dev).contiguous(
                memory_format=torch.channels_last))
        outs[dev] = [t.float().cpu() for t in (*heads, *fpn)]
    assert pc.phase_conv.launches == before
    assert [t.shape[1] for t in outs["cuda"][-3:]] == [256, 512, 1024]
    for g, c in zip(outs["cuda"], outs["cpu"]):
        _assert_close_scaled(g, c, 1e-3, backbone)


@pytest.mark.gpu
def test_demo_featuremap_on_card_without_cv2(cuda, tmp_path, monkeypatch):
    """demo_featuremap --backbone resnet on the card at 64 px with cv2,
    matplotlib, seaborn and tabulate unimportable: every sweep's images,
    figures, gt.json and dt.json written, four AP blocks, a finite table."""
    import os
    import sys

    from eop_tpu_torch.tools import demo_featuremap
    from eop_tpu_torch.utils.synth import write_featuremap_fixture

    fixture = write_featuremap_fixture(str(tmp_path / "fx"), (240, 320))
    for name in ("cv2", "matplotlib", "seaborn", "tabulate"):
        monkeypatch.setitem(sys.modules, name, None)
    out = tmp_path / "out"
    table = demo_featuremap.main([
        "-n", "yolox-s", "--backbone", "resnet", "--tsize", "64",
        "--theta-range", "30,95,30", "--json", fixture, "--conf", "0.003",
        "depth", "0.33", "width", "0.25", "output_dir", str(out)])
    for sweep in ("none", "theta_30", "theta_60", "theta_90"):
        data = os.listdir(out / "new_data" / sweep)
        assert len(data) == 6 and "gt.json" in data
        assert len(os.listdir(out / "yolox_s_resnet" / "vis_res" / sweep)) \
            == 10
        assert (out / "yolox_s_resnet" / "dt_json" / sweep
                / "dt.json").exists()
    assert len(table) == 20
    values = np.array([v for row in table.values() for v in row], float)
    assert np.isfinite(values).sum() > 10


# ---- PASCAL VOC: YOLOX-S from exps/example/yolox_voc/yolox_voc_s.py ----

VOC_EXP = str(Path(__file__).resolve().parents[1] / "exps" / "example"
              / "yolox_voc" / "yolox_voc_s.py")


def _voc_exp(data_dir):
    """The VOC exp as read from its file (depth 0.33, width 0.50, 20
    classes) over ``data_dir``, at 128 px."""
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(VOC_EXP)
    exp.data_dir, exp.data_num_workers = data_dir, 0
    exp.input_size = exp.test_size = (128, 128)
    exp.test_conf = 1e-5
    return exp


@pytest.mark.gpu
def test_voc_detections_on_card_match_cpu(cuda, tmp_path):
    """One image of a seeded devkit through the VOC evaluation loader: the
    forward and decode on the card within 1e-3 of the CPU's (relative to
    the output's scale), the same detections (each box within 1e-2 px of
    one of the CPU's of its class); 8 fused launches a forward.  The
    box-regression weights are scaled by 1e-2 on both devices, so that
    every box lies within the canvas's reach (tests above)."""
    from eop_tpu_torch.utils.synth import write_voc_devkit

    write_voc_devkit(str(tmp_path), 2, 2, (96, 128), seed=0)
    exp = _voc_exp(str(tmp_path))
    img = torch.from_numpy(exp.get_eval_loader(1).dataset[0][0][None])
    out = {}
    for dev in ("cpu", "cuda"):
        model = exp.get_model(dev, seed=3)
        with torch.no_grad():
            for p in model.head.reg_preds:
                p.weight.mul_(1e-2)
        before = (pc.phase_conv.launches, pc.phase_conv.fused_launches)
        decoded = exp.get_decode_fn(model, dev)(img)
        dets = exp.get_infer_fn(model, dev)(img)
        torch.cuda.synchronize()
        out[dev] = (decoded.float().cpu(), dets.rows.cpu(), dets.valid.cpu(),
                    pc.phase_conv.launches - before[0],
                    pc.phase_conv.fused_launches - before[1])
    dec_c, rows_c, valid_c, n_c, _ = out["cpu"]
    dec_g, rows_g, valid_g, n_g, f_g = out["cuda"]
    assert n_c == 0 and n_g == f_g == 16
    assert dec_c.shape[-1] == 4 + 1 + 20
    _assert_close_scaled(dec_g, dec_c, 1e-3, "decoded")
    assert torch.equal(valid_c, valid_g) and valid_c.sum() > 0
    got, want = rows_g[0][valid_g[0]], rows_c[0][valid_c[0]]
    dist = (got[:, None, :4] - want[None, :, :4]).abs().amax(dim=-1)
    dist[got[:, None, 6] != want[None, :, 6]] = float("inf")
    assert dist.amin(dim=1).max().item() <= 1e-2
    assert dist.amin(dim=0).max().item() <= 1e-2


@pytest.mark.gpu
def test_voc_accum_step_on_card_matches_cpu(cuda):
    """One accum=2 step of the VOC exp's YOLOX-S (128 px, B=4: two
    micro-batches of 2) on the card and on the CPU from one state: the
    same foreground count (the assignment), the loss within 1e-3; on the
    card twice one micro-batch's launches by variant (the smoke's
    VOC_MICRO_LAUNCHES: 8 forward, 8 weight and 7 data gradients, 7
    packings), none on the CPU."""
    import chip_smoke
    from eop_tpu_torch.losses import YoloxLossConfig
    from eop_tpu_torch.train.steps import create_train_state, \
        make_train_step_bbox

    exp = _voc_exp(None)
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.uniform(0, 255, (4, 128, 128, 3)).astype(
        np.float32))
    labels = torch.zeros((4, 50, 5))
    for b in range(4):
        for g in range(3):
            w, h = rng.uniform(12, 50, 2)
            labels[b, g] = torch.tensor([rng.randint(20),
                                         rng.uniform(w, 128 - w),
                                         rng.uniform(h, 128 - h), w, h])
    out = {}
    for dev in ("cpu", "cuda"):
        model = exp.get_model(dev, seed=0).train()
        state = create_train_state(model, exp.get_optimizer(model, 4, 1))
        chip_smoke._reset_counts()
        step = make_train_step_bbox(YoloxLossConfig(num_classes=20),
                                    accum_steps=2)
        _, metrics = step(state, imgs.to(dev), labels.to(dev))
        torch.cuda.synchronize()
        out[dev] = (metrics, chip_smoke._launch_counts())
    (m_cpu, n_cpu), (m_gpu, n_gpu) = out["cpu"], out["cuda"]
    want = {k: 2 * v for k, v in chip_smoke.VOC_MICRO_LAUNCHES.items()}
    assert not any(n_cpu.values())
    assert {k: n_gpu[k] for k in want} == want
    assert want["forward:wgmma_rows"] == 2 and want["dgrad"] == 14
    assert m_gpu["num_fg"].item() == m_cpu["num_fg"].item() > 0
    assert abs(m_gpu["total_loss"].item() - m_cpu["total_loss"].item()) <= \
        1e-3 * abs(m_cpu["total_loss"].item())


# ---- the 24p family's drawing tool ----

@pytest.mark.gpu
def test_show_24p_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``tools.show_24p`` on 2 seeded PNGs at 128 px on the card, from a
    reference-form ``.pth``, with cv2 unimportable: 8 fused launches an
    image on the tensor-core variants, both files written and decoded, and
    each image's detections against the CPU run's at the serve phase's
    tolerance (the same count, each polygon's enclosing box matched by IoU,
    median 0.5 or more)."""
    import sys

    from eop_tpu_torch.data.image_io import imread
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.ops.boxes import bboxes_iou
    from eop_tpu_torch.ops.polygon import polygon_points_from_radii
    from eop_tpu_torch.tools import show_24p
    from eop_tpu_torch.utils.synth import write_png

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(7)
    for name, hw in (("a.png", (96, 128)), ("b.png", (128, 100))):
        write_png(str(img_dir / name),
                  rng.randint(0, 256, (*hw, 3)).astype(np.uint8))
    exp = get_exp(exp_name="yolox_24p_s")
    pth = tmp_path / "ref.pth"
    torch.save({"model": exp.get_model("cpu", seed=2).state_dict(),
                "start_epoch": 1}, pth)
    monkeypatch.setitem(sys.modules, "cv2", None)
    runs = {}
    for dev in ("cpu", "cuda"):
        before = (pc.phase_conv.launches, pc.phase_conv.fused_launches,
                  dict(pc.phase_conv.variant_launches))
        ev = show_24p.main(["-n", "yolox_24p_s", "-w", str(pth), "-p",
                            str(img_dir), "--device", dev, "test_conf",
                            "1e-5", "test_size", "(128, 128)", "output_dir",
                            str(tmp_path / dev)])
        runs[dev] = ev.results
        variants = {k: v - before[2].get(k, 0)
                    for k, v in pc.phase_conv.variant_launches.items()}
        if dev == "cuda":
            assert pc.phase_conv.launches - before[0] == 16
            assert pc.phase_conv.fused_launches - before[1] == 16
            assert variants.get("wgmma_rows", 0) == 2
            assert variants.get("wgmma_taps", 0) == 14
            assert variants.get("direct", 0) == 0

    def boxes(rows):
        pts = polygon_points_from_radii(rows[:, :2], rows[:, 2:26])
        return torch.cat([pts.amin(dim=-2), pts.amax(dim=-2)], dim=-1)

    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert imread(got["path"]).shape == imread(want["path"]).shape
        g, w = torch.from_numpy(got["rows"]), torch.from_numpy(want["rows"])
        assert len(g) == len(w) > 0
        best = bboxes_iou(boxes(g), boxes(w)).amax(dim=1)
        assert float(best.median()) >= 0.5


# ---- fp32 accuracy of the tensor-core kernels against float64 ----

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 2, 1, 40, 40, 128, 256),
                                   (3, 1, 1, 40, 40, 64, 64),
                                   (1, 1, 0, 40, 40, 128, 128),
                                   (6, 2, 2, 40, 40, 3, 64),
                                   (3, 1, 1, 40, 40, 3, 32)])
def test_fp32_kernels_match_cudnn_against_float64(cuda, shape):
    """The fp32 forward and data gradient over their longest K chains (3x3
    over 64 and 128 channels; stride 2 through the parity classes, stride 1
    through the flipped forward) and the two stems' forward on
    ``wgmma_rows`` (6x6/s2 and 3x3/s1 over 3 channels; their input takes
    no gradient) against float64 convolutions: each kernel's mean error
    (over the output's largest value) at most 2.2x cuDNN fp32's.  The
    tensor cores add into their accumulator rounding toward zero.  On an
    H100, at these inputs (``chip_smoke.py --kernel-accuracy``, which
    reads them): kernels that sum a whole K chain in one accumulator give
    2.91-25.6x (the 3x3 stem 2.91, the others at least 4.76); short runs
    of K summed apart into an fp32 total give 0.49-1.63x."""
    import torch.nn.functional as F

    k, s, p, h, w, c, co = shape
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, h, w, c, generator=g).to(cuda)
    wt = (torch.randn(k, k, c, co, generator=g)
          / (k * k * c) ** 0.5).to(cuda)
    xn, wn = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
    y64 = F.conv2d(xn.double(), wn.double(), stride=s, padding=p)
    dy = torch.randn(y64.shape, generator=g).to(cuda)
    back = torch.ops.aten.convolution_backward
    dx64 = back(dy.double(), xn.double(), wn.double(), None, [s, s], [p, p],
                [1, 1], False, [0, 0], 1, [True, False, False])[0]
    dx32 = back(dy, xn, wn, None, [s, s], [p, p], [1, 1], False, [0, 0], 1,
                [True, False, False])[0]

    def mean_err(got, ref):
        return ((got.double() - ref).abs().mean()
                / ref.abs().max()).item()

    assert pc.kernel_variant(tuple(x.shape), tuple(wt.shape), s, p,
                             x.dtype) == ("wgmma_taps" if c % 8 == 0
                                          else "wgmma_rows")
    hand = pc.phase_conv(x, wt, s, p).permute(0, 3, 1, 2)
    lib = F.conv2d(xn, wn, stride=s, padding=p)
    fwd = (mean_err(hand, y64), mean_err(lib, y64))
    assert fwd[0] <= 2.2 * fwd[1], fwd
    if c % 8:
        return
    dx = pc.phase_conv_dgrad(dy.permute(0, 2, 3, 1).contiguous(), wt,
                             tuple(x.shape), s, p).permute(0, 3, 1, 2)
    bwd = (mean_err(dx, dx64), mean_err(dx32, dx64))
    assert bwd[0] <= 2.2 * bwd[1], bwd


def _eligible_shapes(device, batch=2):
    """(k, stride, C, Co, B, H, W) of every conv 24p-s (full width, 640
    px) computes in int8 at the default gate, read by forward pre-hooks."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.ops import quant

    exp = get_exp(None, "yolox_24p_s")
    model = exp.get_model(device)
    sites = quant.conv_sites(model)
    shapes, handles = set(), []
    for key, m in sites.items():
        if quant.eligible(m, 64):
            conv = quant._conv(m)

            def hook(_m, args, conv=conv):
                b, c, h, w = args[0].shape
                shapes.add((conv.kernel_size[0], conv.stride[0], c,
                            conv.out_channels, b, h, w))
            handles.append(m.register_forward_pre_hook(hook))
    with torch.inference_mode():
        model(torch.zeros((batch, 3, 640, 640), device=device))
    for h in handles:
        h.remove()
    return sorted(shapes)


@pytest.mark.gpu
def test_int8_conv_on_card_bit_equal_to_cpu(cuda):
    """The int32 accumulator of every int8 conv of 24p-s (B=2, 640 px):
    patches and ``torch._int_mm`` (cuBLASLt) on the card, the same on the
    CPU, equal bit for bit; the codes from one fp32 input quantized on each
    device are equal too (a true division on both)."""
    from eop_tpu_torch.ops import quant

    shapes = _eligible_shapes(cuda)
    assert len(shapes) >= 10
    g = torch.Generator().manual_seed(0)
    for k, s, c, co, b, h, w in shapes:
        x = torch.randn((b, h, w, c), generator=g) * 3
        s_x = torch.tensor(float(x.abs().max()) / 127.0)
        q_x = quant.quantize_act(x, s_x)
        assert torch.equal(quant.quantize_act(x.to(cuda), s_x.to(cuda)).cpu(),
                           q_x)
        q_w = torch.randint(-127, 128, (co, k * k * c), generator=g,
                            dtype=torch.int8).t()
        want = quant.int8_conv(q_x, q_w, k, s, (k - 1) // 2)
        got = quant.int8_conv(q_x.to(cuda), q_w.to(cuda), k, s, (k - 1) // 2)
        assert torch.equal(got.cpu(), want), (k, s, c, co, h, w)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_artifact_exported_on_card_equals_live_serving(cuda, tmp_path, int8):
    """24p-s at full width, 720x1280 frames at B=2: the artifact exported
    and loaded on the card gives the live serving function's rows and
    valid mask, and its graph launches phase_conv's kernels, counted from
    inside the registered operator."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.ops import quant
    from eop_tpu_torch.utils.serving_export import (
        calibration_batch, export_serving, load_serving_artifact,
        save_serving_artifact)

    exp = get_exp(None, "yolox_24p_s")
    exp.test_conf = 1e-5
    model = exp.get_model(cuda)
    src_hw = (720, 1280)
    scales = None
    if int8:
        model, scales = exp.quantize_for_inference(
            model, [calibration_batch(None, src_hw, exp.test_size,
                                      device=cuda)])
    raw = np.random.RandomState(0).randint(0, 256, (2, *src_hw, 3), np.uint8)
    live = exp.get_serving_fn(model, src_hw, cuda, scales)(raw)
    path = str(tmp_path / "a.pt2")
    save_serving_artifact(export_serving(exp, model, 2, src_hw, cuda, scales),
                          path, {"test_size": list(exp.test_size)})
    prog = load_serving_artifact(path, cuda)
    before = (pc.phase_conv.launches, pc.phase_conv.fused_launches,
              quant.int8_conv.calls)
    with torch.no_grad():
        rows, valid = prog.module()(torch.from_numpy(raw).to(cuda))
    torch.cuda.synchronize()
    launched = (pc.phase_conv.launches - before[0],
                pc.phase_conv.fused_launches - before[1],
                quant.int8_conv.calls - before[2])
    assert launched[:2] == ((6, 6) if int8 else (8, 8))
    assert (launched[2] > 0) == int8
    assert valid.sum() > 0
    assert torch.equal(valid, live.valid) and torch.equal(rows, live.rows)


# --- data parallelism (eop_tpu_torch/parallel)

def _launch_counts():
    c = pc.phase_conv
    return (dict(c.variant_launches), dict(c.wgrad_variant_launches),
            dict(c.dgrad_variant_launches))


def _launches_since(before):
    return tuple({k: v - b.get(k, 0) for k, v in now.items()
                  if v - b.get(k, 0)}
                 for b, now in zip(before, _launch_counts()))


@pytest.mark.gpu
def test_world_one_nccl_step_matches_the_plain_step(cuda):
    """A group of one over NCCL on the card: ``convert_global_bn``, the
    loss with the group and ``shard_train_step`` (its gradient all_reduce)
    give the plain step's loss, num_fg and update within fp32 noise, with
    the same hand-kernel launches by variant."""
    import socket

    import torch.distributed as dist

    from eop_tpu_torch.exp import Exp24P
    from eop_tpu_torch.losses import Loss24PConfig
    from eop_tpu_torch.parallel import convert_global_bn, shard_train_step
    from eop_tpu_torch.parallel.dist import init_distributed
    from eop_tpu_torch.train.steps import (
        create_train_state,
        make_train_step_24p,
    )
    from eop_tpu_torch.utils.synth import synthetic_24p_batch

    imgs, labels = synthetic_24p_batch(
        torch.Generator().manual_seed(2), 4, size=128, ngt=3, r_lo=8.0,
        r_hi=30.0)
    imgs, labels = imgs.to(cuda), labels.to(cuda)
    exp = Exp24P()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, 3
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    made = init_distributed("cuda", f"127.0.0.1:{port}", 1, 0)
    try:
        out = {}
        for mode in ("plain", "dp"):
            model = exp.get_model(cuda, seed=3).train()
            group = dist.group.WORLD if mode == "dp" else None
            if group is not None:
                convert_global_bn(model, group)
            state = create_train_state(
                model, exp.get_optimizer(model, 4, lr=1e-3), use_ema=False,
                with_dwa=True)
            step = shard_train_step(make_train_step_24p(
                Loss24PConfig(num_classes=3), group=group), group)
            before = _launch_counts()
            state, m = step(state, imgs, labels)
            torch.cuda.synchronize()
            out[mode] = (m["total_loss"].item(), m["num_fg"].item(),
                         _launches_since(before),
                         {k: v.detach().cpu()
                          for k, v in model.state_dict().items()})
    finally:
        if made:
            dist.destroy_process_group()
    plain, dp = out["plain"], out["dp"]
    assert abs(dp[0] - plain[0]) <= 1e-5 * abs(plain[0])
    assert dp[1] == plain[1]
    assert dp[2] == plain[2]
    assert sum(dp[2][0].values()) == 8 and sum(dp[2][1].values()) == 8
    assert sum(dp[2][2].values()) == 7
    for k, v in plain[3].items():
        if v.is_floating_point():
            bound = 1e-5 * max(v.abs().max().item(), 1e-6)
            assert (dp[3][k] - v).abs().max().item() <= bound, k
        else:
            assert torch.equal(dp[3][k], v), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_global_batch_norm_on_card_matches_batchnorm(cuda, dtype, tol):
    """The global BatchNorm's arithmetic (no group) on CUDA tensors against
    the port's BatchNorm2d (output, input gradient, running statistics) and
    against BatchNorm2d in float64 on the same inputs (the parameter
    gradients: the card's bf16 BatchNorm sums them less precisely)."""
    from eop_tpu_torch.ops.blocks import BatchNorm2d
    from eop_tpu_torch.parallel import global_batch_norm

    tdt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(8, 32, 20, 20, generator=g) * 2 + 0.5).to(cuda, tdt)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape, generator=g).to(cuda, tdt)
    ref = BatchNorm2d(32, eps=1e-3, momentum=0.03).to(cuda).train()
    with torch.no_grad():
        ref.weight.uniform_(0.5, 1.5)
        ref.bias.uniform_(-0.5, 0.5)
    w = ref.weight.detach().clone().requires_grad_()
    b = ref.bias.detach().clone().requires_grad_()
    rm, rv = ref.running_mean.clone(), ref.running_var.clone()
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    y = global_batch_norm(xa, w, b, rm, rv, 0.03, 1e-3)
    yr = ref(xb)
    (y.float() * dy.float()).sum().backward()
    (yr.float() * dy.float()).sum().backward()
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(xa.grad.float(), xb.grad.float(), atol=tol,
                               rtol=tol)
    ref64 = BatchNorm2d(32, eps=1e-3, momentum=0.03).to(cuda).double()
    with torch.no_grad():
        ref64.weight.copy_(w)
        ref64.bias.copy_(b)
    (ref64.train()(x.double()) * dy.double()).sum().backward()
    for got, want in ((w.grad, ref64.weight.grad), (b.grad, ref64.bias.grad)):
        err = (got.double() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
    torch.testing.assert_close(rm, ref.running_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rv, ref.running_var, atol=1e-5, rtol=1e-5)
