"""The backward of the port's phase_conv on the CPU: the plain data- and
weight-gradient versions against ``jax.vjp`` of ``lax.conv_general_dilated``
(which the JAX ``phase_conv`` equals, tests/test_pallas_conv.py), gradcheck
in float64, the flipped-kernel identity and the ``autograd.Function``.  The
CUDA kernels' own tests are in test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu_torch.ops import phase_conv as pc
from eop_tpu_torch.ops.blocks import BaseConv, Focus


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (tests/test_torch_bbox_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the 8 convs of the 24p-s main path (width 0.5) at 1/10 of 640 px, then
# ragged shapes: (k, stride, padding, H, W, C, Co)
SHAPES = {
    "stem": (6, 2, 2, 64, 64, 3, 32),
    "dark2_conv": (3, 2, 1, 32, 32, 32, 64),
    "dark2_csp.conv1": (1, 1, 0, 16, 16, 64, 32),
    "dark2_csp.conv2": (1, 1, 0, 16, 16, 64, 32),
    "dark2_csp.m0.conv1": (1, 1, 0, 16, 16, 32, 32),
    "dark2_csp.m0.conv2": (3, 1, 1, 16, 16, 32, 32),
    "dark2_csp.conv3": (1, 1, 0, 16, 16, 64, 64),
    "dark3_conv": (3, 2, 1, 16, 16, 64, 128),
    "ragged_odd_co": (3, 1, 1, 12, 20, 32, 33),
    "ragged_c48": (3, 2, 1, 16, 12, 48, 64),
    "ragged_k5": (5, 1, 2, 9, 11, 5, 7),
    "ragged_k4": (4, 2, 1, 16, 16, 8, 16),
    "ragged_k1_s2": (1, 2, 0, 8, 6, 16, 24),
}


def _inputs(shape, seed=0, batch=2):
    k, s, p, h, w, c, co = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, h, w, c).astype(np.float32)
    wgt = (rng.randn(k, k, c, co) * 0.1).astype(np.float32)
    ho, wo = pc.out_hw(h, w, k, s, p)
    dy = rng.randn(batch, ho, wo, co).astype(np.float32)
    return x, wgt, dy


def _jax_grads(x, wgt, dy, s, p, dtype=jnp.float32):
    def conv(x_, w_):
        return jax.lax.conv_general_dilated(
            x_, w_, window_strides=(s, s), padding=[(p, p), (p, p)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    _, vjp = jax.vjp(conv, jnp.asarray(x, dtype), jnp.asarray(wgt, dtype))
    dx, dw = vjp(jnp.asarray(dy, dtype))
    return np.asarray(dx, np.float32), np.asarray(dw, np.float32)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_gradients_match_jax_vjp(name):
    """fp32: 1e-4 x the gradient's scale (sums of up to 2k terms in another
    order)."""
    k, s, p = SHAPES[name][:3]
    x, wgt, dy = _inputs(SHAPES[name])
    want_dx, want_dw = _jax_grads(x, wgt, dy, s, p)
    dw = pc.phase_conv_wgrad_reference(
        torch.from_numpy(x), torch.from_numpy(dy), k, s, p)
    dx = pc.phase_conv_dgrad_reference(
        torch.from_numpy(dy), torch.from_numpy(wgt), x.shape, s, p)
    assert tuple(dx.shape) == x.shape and tuple(dw.shape) == wgt.shape
    for got, want in ((dx, want_dx), (dw, want_dw)):
        tol = 1e-4 * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("name", ["stem", "dark2_conv", "dark2_csp.m0.conv2",
                                  "ragged_c48"])
def test_plain_gradients_bf16_match_jax_vjp(name):
    """bf16 in and out, fp32 accumulation on both sides: 2e-2 x scale (one
    bf16 rounding of the result, and XLA's own accumulation choices)."""
    k, s, p = SHAPES[name][:3]
    x, wgt, dy = _inputs(SHAPES[name], seed=1)
    want_dx, want_dw = _jax_grads(x, wgt, dy, s, p, jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    dw = pc.phase_conv_wgrad_reference(tb(x), tb(dy), k, s, p)
    dx = pc.phase_conv_dgrad_reference(tb(dy), tb(wgt), x.shape, s, p)
    assert dw.dtype == dx.dtype == torch.bfloat16
    for got, want in ((dx, want_dx), (dw, want_dw)):
        tol = 2e-2 * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("shape", [
    (3, 1, 1, 5, 6, 3, 4), (3, 2, 1, 6, 8, 3, 4), (6, 2, 2, 8, 8, 3, 4),
    (1, 1, 0, 4, 5, 4, 3), (4, 2, 1, 8, 6, 2, 3), (1, 2, 0, 4, 4, 2, 3),
])
def test_autograd_function_gradcheck_float64(shape):
    """The Function's backward (the plain dgrad and wgrad) against numerical
    derivatives of its forward (the plain phase form), in float64."""
    k, s, p, h, w, c, co = shape
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, h, w, c)).requires_grad_()
    wgt = torch.from_numpy(rng.randn(k, k, c, co)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: pc.phase_conv(a, b, s, p), (x, wgt))


@pytest.mark.parametrize("name", [n for n, v in SHAPES.items() if v[1] == 1])
def test_stride1_dgrad_is_forward_on_flipped_weights(name):
    """dx = phase_conv(dy, w', 1, p) with w'[ky,kx,co,c] =
    w[k-1-ky,k-1-kx,c,co]; 1e-5 x scale."""
    k, s, p = SHAPES[name][:3]
    x, wgt, dy = _inputs(SHAPES[name], seed=3)
    dy_t, w_t = torch.from_numpy(dy), torch.from_numpy(wgt)
    flipped = pc.flipped_weights(w_t)
    assert tuple(flipped.shape) == (k, k, wgt.shape[3], wgt.shape[2])
    got = pc.phase_conv_reference(dy_t, flipped, 1, p)
    want = pc.phase_conv_dgrad_reference(dy_t, w_t, x.shape, 1, p)
    tol = 1e-5 * max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)


def test_dgrad_variant_follows_the_forward_predicate():
    f32 = torch.float32
    # main path: stride 1 -> the tensor-core forward on flipped weights
    for name in ("dark2_csp.conv1", "dark2_csp.m0.conv2", "dark2_csp.conv3"):
        k, s, p, h, w, c, co = SHAPES[name]
        assert pc.dgrad_variant((8, h, w, co), (k, k, c, co), s, p,
                                f32) == "flipped:wgmma_taps"
    # stride 2 on the main path, and wherever C and Co are multiples of 8
    # (C = 48; a 1x1 with classes no tap reaches) -> the tensor-core
    # parity-class kernel
    for name in ("dark2_conv", "dark3_conv", "ragged_c48", "ragged_k1_s2"):
        k, s, p, h, w, c, co = SHAPES[name]
        ho, wo = pc.out_hw(h, w, k, s, p)
        assert pc.dgrad_variant((8, ho, wo, co), (k, k, c, co), s, p,
                                f32) == "wgmma_classes"
    # shapes off the predicates -> the CUDA-core gather kernel
    for name in ("stem", "ragged_odd_co", "ragged_k5", "ragged_k4"):
        k, s, p, h, w, c, co = SHAPES[name]
        ho, wo = pc.out_hw(h, w, k, s, p)
        assert pc.dgrad_variant((8, ho, wo, co), (k, k, c, co), s, p,
                                f32) == "cuda_cores"


def test_autograd_function_on_cpu_tensors_and_counters():
    """On CPU tensors the Function runs the plain versions, launches nothing
    and returns what autograd through the plain forward returns."""
    k, s, p = SHAPES["dark2_conv"][:3]
    x, wgt, dy = _inputs(SHAPES["dark2_conv"], seed=4)
    counters = ("launches", "wgrad_launches", "dgrad_launches", "dy_copies")
    before = [getattr(pc.phase_conv, c) for c in counters]
    xa = torch.from_numpy(x).requires_grad_()
    wa = torch.from_numpy(wgt).requires_grad_()
    y = pc.phase_conv(xa, wa, s, p)
    assert y.grad_fn is not None and "PhaseConvFunction" in type(
        y.grad_fn).__name__
    # a dense NCHW gradient viewed as NHWC: copied once, counted
    dy_t = torch.from_numpy(dy).permute(0, 3, 1, 2).contiguous().permute(
        0, 2, 3, 1)
    dx, dw = torch.autograd.grad(y, (xa, wa), dy_t)
    xb = torch.from_numpy(x).requires_grad_()
    wb = torch.from_numpy(wgt).requires_grad_()
    want = torch.autograd.grad(pc.phase_conv_reference(xb, wb, s, p),
                               (xb, wb), torch.from_numpy(dy))
    for got, ref in ((dx, want[0]), (dw, want[1])):
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol, rtol=0)
    after = [getattr(pc.phase_conv, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [0, 0, 0, 1]
    # an input that takes no gradient gets none
    y = pc.phase_conv(torch.from_numpy(x), wa, s, p)
    (dw2,) = torch.autograd.grad(y, (wa,), torch.from_numpy(dy))
    np.testing.assert_array_equal(dw2.numpy(), dw.numpy())


def test_epilogue_under_autograd():
    """With scale/shift/act a CPU call differentiates through the plain
    version; the kernels' wrapper refuses (checked on the card)."""
    x, wgt, _ = _inputs((3, 1, 1, 6, 6, 4, 8), seed=5)
    xa = torch.from_numpy(x).requires_grad_()
    scale, shift = torch.full((8,), 1.5), torch.full((8,), 0.1)
    y = pc.phase_conv(xa, torch.from_numpy(wgt), 1, 1, scale, shift, "silu")
    y.sum().backward()
    assert xa.grad is not None and torch.isfinite(xa.grad).all()


@pytest.mark.parametrize("block", ["baseconv_s1", "baseconv_s2", "focus"])
def test_gradient_reaches_the_leaf_parameters(block):
    """BaseConv(phase_conv=True) in train mode: the gradient passes the HWIO
    permutation (and the Focus fold) to ``conv.weight`` and equals the
    F.conv2d route's; also after the module ran in eval mode, whose cached
    weight carries no graph.  1e-5 x scale."""
    torch.manual_seed(0)
    if block == "focus":
        make = lambda pconv: Focus(3, 8, 3, phase_conv=pconv)  # noqa: E731
        cin, weight_of = 3, lambda m: m.conv.conv.weight
    else:
        stride = 1 if block.endswith("s1") else 2
        make = lambda pconv: BaseConv(4, 8, 3, stride, phase_conv=pconv)  # noqa: E731
        cin, weight_of = 4, lambda m: m.conv.weight
    a, b = make(True), make(False)
    b.load_state_dict(a.state_dict())
    x = torch.randn(2, cin, 8, 8)
    with torch.no_grad():
        a.eval()(x)      # fills the eval-mode weight cache
    grads = []
    for m in (a, b):
        m.train()
        m(x).square().sum().backward()
        grads.append(weight_of(m).grad)
    assert grads[0] is not None and grads[0].shape == weight_of(a).shape
    tol = 1e-5 * max(1.0, grads[1].abs().max().item())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=tol,
                               rtol=0)


def test_packed_weight_cache_does_not_grow_or_go_stale():
    """Train mode hands a fresh HWIO tensor every step: the packing cache
    drops each entry with its tensor, and an in-place update of a cached
    weight is seen."""
    pc._packed.clear()
    packs0 = pc.packed_weights.packs
    w = torch.randn(3, 3, 32, 32)
    for _ in range(5):
        fresh = (w * 1.0).contiguous()
        pc.packed_weights(fresh, "wgmma_taps")
        del fresh
    assert len(pc._packed) == 0
    assert pc.packed_weights.packs - packs0 == 5
    first = pc.packed_weights(w, "wgmma_taps").clone()
    assert pc.packed_weights.packs - packs0 == 6
    pc.packed_weights(w, "wgmma_taps")
    assert pc.packed_weights.packs - packs0 == 6     # cached
    w.mul_(2.0)                                      # what an optimizer does
    second = pc.packed_weights(w, "wgmma_taps")
    assert pc.packed_weights.packs - packs0 == 7
    np.testing.assert_array_equal(second.numpy(), (first * 2.0).numpy())
    del w
    assert len(pc._packed) == 0
