"""Train-mode behaviour of the port's blocks against the JAX package's:
BatchNorm running statistics (flax blends the biased batch variance) and the
SPP max pool's tie-splitting backward."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from eop_tpu.ops import blocks as jblocks
from eop_tpu_torch.ops import blocks as tblocks
from eop_tpu_torch.utils.weights import state_dict_from_jax


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("batch,hw", [(2, 6), (1, 3)])
def test_bn_running_stats_match_flax_after_three_train_steps(batch, hw):
    """BaseConv (conv -> BN -> SiLU) for 3 train steps on the same inputs:
    outputs 1e-5, running mean and variance 1e-6.  With 9 to 72 values per
    channel the unbiased variance nn.BatchNorm2d would blend is off by 1.4 to
    12 % per step."""
    rng = np.random.RandomState(0)
    xs = [rng.randn(batch, hw, hw, 4).astype(np.float32) * 2.0 + 0.5
          for _ in range(3)]
    jmod = jblocks.BaseConv(8, 3, 1)
    variables = _to_np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0])))
    variables["batch_stats"]["bn"]["var"] = rng.uniform(
        0.5, 1.5, 8).astype(np.float32)
    variables["batch_stats"]["bn"]["mean"] = rng.randn(8).astype(np.float32)
    variables["params"]["bn"]["scale"] = rng.uniform(
        0.5, 1.5, 8).astype(np.float32)

    tmod = tblocks.BaseConv(4, 8, 3, 1)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert isinstance(tmod.bn, nn.BatchNorm2d)  # same keys, strict loading
    tmod.train()

    stats = variables["batch_stats"]
    for x in xs:
        want, mut = jmod.apply(
            {"params": variables["params"], "batch_stats": stats},
            jnp.asarray(x), True, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(
            got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
            atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tmod.bn.running_mean.numpy(),
                               np.asarray(stats["bn"]["mean"]), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tmod.bn.running_var.numpy(),
                               np.asarray(stats["bn"]["var"]), atol=1e-6,
                               rtol=1e-6)
    assert int(tmod.bn.num_batches_tracked) == 3

    # the parent class would have blended the unbiased variance
    ref = nn.BatchNorm2d(8, eps=tblocks.BN_EPS, momentum=tblocks.BN_MOMENTUM)
    ref.train()
    own = tblocks.BatchNorm2d(8, eps=tblocks.BN_EPS,
                              momentum=tblocks.BN_MOMENTUM).train()
    y = torch.randn(batch, 8, hw, hw)
    np.testing.assert_allclose(own(y).detach().numpy(),
                               ref(y).detach().numpy(), atol=1e-6)
    n = batch * hw * hw
    np.testing.assert_allclose(
        (own.running_var - (1 - tblocks.BN_MOMENTUM)).numpy() * n / (n - 1),
        (ref.running_var - (1 - tblocks.BN_MOMENTUM)).numpy(), atol=1e-6)


def test_bn_eval_mode_and_gradients_unchanged():
    """Eval mode uses the running statistics and touches nothing; the train
    forward's gradients equal nn.BatchNorm2d's."""
    torch.manual_seed(1)
    own = tblocks.BatchNorm2d(5, eps=1e-3, momentum=0.03)
    ref = nn.BatchNorm2d(5, eps=1e-3, momentum=0.03)
    x = torch.randn(3, 5, 4, 4)
    grads = []
    for m in (own, ref):
        xi = x.clone().requires_grad_()
        (m.train()(xi) * torch.arange(5.0).view(1, 5, 1, 1)).square().sum(
        ).backward()
        grads.append((xi.grad, m.weight.grad, m.bias.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    before = own.running_var.clone()
    own.eval()(x)
    assert torch.equal(own.running_var, before)
    with pytest.raises(ValueError):
        own.train()(torch.randn(1, 5, 1, 1))


def _tied_input(dtype):
    """Values on a coarse grid, so that most windows hold several equal
    maxima."""
    rng = np.random.RandomState(2)
    x = rng.randint(0, 3, (2, 7, 9, 4)).astype(np.float32)
    x[0, 2:5, 3:6, :] = 5.0       # a plateau larger than the small window
    g = rng.randn(2, 7, 9, 4).astype(np.float32)
    return x, g


@pytest.mark.parametrize("ksize", [3, 5, 9, 13])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_backward_splits_ties_like_the_jax_vjp(ksize, dtype):
    """dx of the separable pool against jax.vjp of ``_maxpool_same`` on an
    input full of ties: fp32 1e-6; bf16 2e-2 x scale (both sides divide and
    sum in bf16, in orders that differ)."""
    x, g = _tied_input(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y_j, vjp = jax.vjp(lambda a: jblocks._maxpool_same(a, ksize),
                       jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_()
    y_t = tblocks.maxpool_same(xt, ksize)
    (got,) = torch.autograd.grad(
        y_t, xt, torch.from_numpy(g).to(tdt).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(
        y_t.detach().float().permute(0, 2, 3, 1).numpy(),
        np.asarray(y_j, np.float32))
    want = np.asarray(want, np.float32)
    tol = 1e-6 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), want,
                               atol=tol, rtol=0)
    if dtype == "float32":
        # the gradient's mass is conserved, and ties really were split
        np.testing.assert_allclose(got.sum().item(), g.sum(), rtol=1e-4)
        first_only = torch.autograd.grad(
            nn.functional.max_pool2d(xt, ksize, 1, ksize // 2), xt,
            torch.from_numpy(g).permute(0, 3, 1, 2))[0]
        assert (got - first_only).abs().max().item() > 0.1


def test_spp_forward_values_do_not_depend_on_autograd():
    """SPPBottleneck uses nn.MaxPool2d without autograd and the
    tie-splitting pool with it: the same values."""
    torch.manual_seed(3)
    spp = tblocks.SPPBottleneck(8, 8).eval()
    x = torch.randn(2, 8, 10, 10)
    with torch.no_grad():
        served = spp(x)
    trained = spp(x.clone().requires_grad_())
    assert trained.requires_grad
    np.testing.assert_array_equal(served.numpy(), trained.detach().numpy())
