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
