"""Tests that need a CUDA card: the hand-written kernels against their plain
versions, and the port's model on the card against the CPU.  They import
neither JAX nor eop_tpu, so they run where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

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
    (3, 2, 1, 16, 12, 48, 64),   # C no multiple of 32
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
        assert all(m._bn_cached is not None for m in model.modules()
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
                                 part.data_ptr(), 1, 10 ** 6, 1, 4, 0,
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
