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
    [((6, 2, 2, 128, 128, 3, 64), "direct", "cuda_cores", None),
     ((3, 2, 1, 64, 64, 64, 128), "wgmma_taps", "wgmma", "wgmma_classes")]
    + [((1, 1, 0, 32, 32, 128, 64), "wgmma_taps", "wgmma",
        "flipped:wgmma_taps")] * 2
    + [((k, 1, k // 2, 32, 32, 64, 64), "wgmma_taps", "wgmma",
        "flipped:wgmma_taps") for _ in range(3) for k in (1, 3)]
    + [((1, 1, 0, 32, 32, 128, 128), "wgmma_taps", "wgmma",
        "flipped:wgmma_taps"),
       ((3, 2, 1, 32, 32, 128, 256), "direct", "cuda_cores",
        "wgmma_classes")])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_yolox_l_shapes_take_their_variants(cuda, dtype, tol):
    """The YOLOX-L early convs: forward (with and without the fused
    epilogue), weight and data gradient against their plain versions, each
    on the variant the 640 px path takes (the stem and dark3's down conv on
    the CUDA-core direct forward and cuda_cores weight gradient)."""
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
# channel counts decide the variants
ZOO_SHAPES = [
    ((6, 2, 2, 42, 42, 3, 16), "direct", "cuda_cores", "cuda_cores"),
    ((1, 1, 0, 10, 10, 16, 32), "direct", "cuda_cores", "cuda_cores"),
    ((1, 1, 0, 10, 10, 32, 16), "direct", "cuda_cores", "cuda_cores"),
    ((1, 1, 0, 6, 6, 32, 64), "wgmma_taps", "wgmma", "flipped:wgmma_taps"),
    ((6, 2, 2, 64, 64, 3, 24), "direct", "cuda_cores", "cuda_cores"),
    ((3, 2, 1, 32, 32, 24, 48), "direct", "cuda_cores", "cuda_cores"),
    ((3, 1, 1, 16, 16, 24, 24), "direct", "cuda_cores", "cuda_cores"),
    ((3, 2, 1, 16, 16, 48, 96), "direct", "cuda_cores", "cuda_cores"),
    ((3, 1, 1, 64, 64, 3, 32), "direct", "wgmma", "cuda_cores"),
    ((3, 2, 1, 64, 64, 32, 64), "wgmma_taps", "wgmma", "wgmma_classes"),
    ((3, 2, 1, 16, 16, 128, 256), "direct", "cuda_cores", "wgmma_classes"),
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
    assert m_gpu["num_fg"].item() == m_cpu["num_fg"].item() > 0
    assert abs(m_gpu["total_loss"].item() - m_cpu["total_loss"].item()) <= \
        1e-4 * abs(m_cpu["total_loss"].item())
