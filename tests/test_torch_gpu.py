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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_phase_conv_kernel_matches_plain(cuda, dtype, tol):
    tdt = getattr(torch, dtype)
    before = pc.phase_conv.launches
    for i, (k, s, p, h, w, c, co) in enumerate(SHAPES):
        rng = np.random.RandomState(i)
        x = torch.from_numpy(rng.randn(2, h, w, c).astype(np.float32))
        wgt = torch.from_numpy((rng.randn(k, k, c, co) * 0.1).astype(np.float32))
        x, wgt = x.to(cuda, tdt), wgt.to(cuda, tdt)
        got = pc.phase_conv(x, wgt, s, p)
        want = pc.phase_conv_reference(x, wgt, s, p)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == tdt
        bound = tol * max(1.0, want.float().abs().max().item())
        err = (got.float() - want.float()).abs().max().item()
        assert err <= bound, ((k, s, p, h, w, c, co), err, bound)
    assert pc.phase_conv.launches - before == len(SHAPES)


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
    for g, c in zip(heads["cuda"], heads["cpu"]):
        np.testing.assert_allclose(g.numpy(), c.numpy(), atol=1e-3, rtol=1e-3)
