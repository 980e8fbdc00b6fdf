"""The port's model (eop_tpu_torch/models) against the JAX package's, with
JAX-initialised weights carried across by the port's weight bridge."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

from eop_tpu.exp.yolox_24p_base import Exp24P as JaxExp24P
from eop_tpu.models import CSPDarknet as JaxCSPDarknet
from eop_tpu.models import init_model
from eop_tpu.utils.torch_export import variables_to_state_dict
from eop_tpu_torch.exp import Exp24P
from eop_tpu_torch.models.darknet import CSPDarknet
from eop_tpu_torch.utils.weights import state_dict_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
TAPS = ("stem", "dark2", "dark3", "dark4", "dark5")


def tiny(exp):
    exp.depth, exp.width, exp.num_classes = 0.33, 0.125, 3
    exp.test_size = (64, 64)
    return exp


def perturbed(variables, seed=0):
    """numpy copy of the JAX variables with random BN affine and running
    statistics (fresh ones are the identity, which would hide a mix-up)."""
    rng = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(np.asarray, unfreeze(variables))

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif "bn" in path and k in ("scale", "var"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
            elif "bn" in path and k in ("bias", "mean"):
                tree[k] = (rng.randn(*v.shape) * 0.1).astype(v.dtype)

    walk(out)
    return out


@pytest.fixture(scope="module")
def bridged():
    jexp = tiny(JaxExp24P())
    jmodel = jexp.get_model()
    variables = perturbed(init_model(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    model = tiny(Exp24P()).get_model("cpu")
    sd = state_dict_from_jax(variables)
    model.load_state_dict(sd, strict=True)
    x = np.random.RandomState(3).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    return jmodel, variables, model, sd, x


def nchw(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def test_bridge_equals_jax_exporter_and_loads_strictly(bridged):
    _, variables, model, sd, _ = bridged
    want = variables_to_state_dict(variables)
    assert set(sd) == set(want) == set(model.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # the Focus kernel keeps the reference parameter shape
    assert tuple(sd["backbone.backbone.stem.conv.conv.weight"].shape) == \
        (int(64 * 0.125), 12, 3, 3)


def test_cspdarknet_taps_match_jax(bridged):
    _, variables, _, sd, x = bridged
    sub = {k: v["backbone"]["backbone"] for k, v in variables.items()}
    want = JaxCSPDarknet(0.33, 0.125, out_features=TAPS).apply(sub, x, False)
    net = CSPDarknet(0.33, 0.125, out_features=TAPS).eval()
    prefix = "backbone.backbone."
    net.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                         if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        got = net(nchw(x))
    for name in TAPS:
        np.testing.assert_allclose(
            got[name].permute(0, 2, 3, 1).numpy(), np.asarray(want[name]),
            err_msg=name, **TOL)


def test_fpn_outs_and_head_maps_match_jax(bridged):
    jmodel, variables, model, _, x = bridged
    want_heads, want_fpn = jmodel.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        heads, fpn = model(nchw(x))
    assert len(fpn) == 6 and len(heads) == 3
    for i, (g, w) in enumerate(zip(fpn, want_fpn)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), err_msg=f"fpn {i}", **TOL)
    for i, (g, w) in enumerate(zip(heads, want_heads)):
        assert g.shape[1] == 26 + 1 + 3
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), err_msg=f"head {i}", **TOL)


def test_phase_conv_modules_are_the_eight_early_convs():
    model = tiny(Exp24P()).get_model("cpu")
    names = sorted(n for n, m in model.named_modules()
                   if getattr(m, "phase_conv", False) is True)
    prefix = "backbone.backbone."
    assert names == sorted(prefix + n for n in (
        "stem.conv", "dark2.0", "dark2.1.conv1", "dark2.1.conv2",
        "dark2.1.m.0.conv1", "dark2.1.m.0.conv2", "dark2.1.conv3",
        "dark3.0"))


def test_inference_outputs_match_jax(bridged):
    from eop_tpu.models import inference_outputs as jax_inference_outputs
    from eop_tpu_torch.models.yolox import inference_outputs

    jmodel, variables, model, _, x = bridged
    want_heads, _ = jmodel.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        heads, _ = model(nchw(x))
    want = jax_inference_outputs(want_heads, reg_dim=26)
    got = inference_outputs(heads, reg_dim=26)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
