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
