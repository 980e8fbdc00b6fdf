"""The depthwise and YOLOv3 modules of the port against the JAX package's:
``BaseConv(groups=)``, ``DWConv`` and ``ResLayer`` (eval, train mode and
gradients), ``Darknet`` 21 and 53, ``YOLOFPN``, ``YOLOv3`` and YOLOX at
YOLOX-Nano's structure (depth 0.33, width 0.25, ``depthwise=True``), with
the JAX variables carried across by the port's weight bridge, and the
bridge's YOLOv3 names against ``eop_tpu``'s importer.

The JAX variables are random numpy trees of the shapes ``init`` gives
(``jax.eval_shape``: no compile), with BatchNorm statistics and affine away
from the identity.  fp32 bound: 1e-4 of each output's largest value (the
port's parity bar), 1e-5 for the single blocks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.models import YOLOX as JYOLOX
from eop_tpu.models import YOLOv3 as JYOLOv3
from eop_tpu.models.darknet import Darknet as JDarknet
from eop_tpu.ops import blocks as jblocks
from eop_tpu.utils.torch_import import convert_state_dict, map_yolofpn_key
from eop_tpu_torch.exp import Exp
from eop_tpu_torch.models.darknet import Darknet
from eop_tpu_torch.models.pafpn import YOLOFPN
from eop_tpu_torch.models.yolox import YOLOX, YOLOv3
from eop_tpu_torch.ops import blocks as tblocks
from eop_tpu_torch.utils.weights import state_dict_from_jax, unmap_yolofpn_key

SIZE, CLASSES = 64, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(module, x, seed=0):
    """numpy variables of ``module``'s init shapes: LeCun-normal kernels,
    small biases, BatchNorm scale and variance in 0.5..1.5, mean and bias
    around 0."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x,
                                                False))
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = fill(v)
                continue
            if k == "kernel":
                a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
            elif k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, v.shape)
            else:
                a = rng.randn(*v.shape) * 0.1
            out[k] = a.astype(np.float32)
        return out

    return fill(dict(shapes))


def japply(module, variables, x):
    """Eval-mode ``module.apply``, jitted (a fraction of an op-by-op run's
    compile time)."""
    return jax.jit(lambda v, xx: module.apply(v, xx, False))(
        variables, jnp.asarray(x))


def image(batch=1, seed=1):
    return np.random.RandomState(seed).uniform(
        0, 255, (batch, SIZE, SIZE, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def assert_maps(got, want, tol=1e-4, what="map"):
    """NCHW torch maps against NHWC JAX maps, 1e-4 of the largest value."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * np.abs(w).max(),
                                   err_msg=f"{what} {i}")


def jax_yolov3(depth: int, num_classes: int):
    """eop_tpu's YOLOv3 over Darknet ``depth`` (its own class is 53)."""
    from flax import linen as nn

    from eop_tpu.models.head import YOLOXHead
    from eop_tpu.models.pafpn import YOLOFPN

    class JYOLOv3At(JYOLOv3):
        @nn.compact
        def __call__(self, x, train=False):
            fpn = YOLOFPN(depth=depth, name="backbone")(x, train)
            return YOLOXHead(num_classes=self.num_classes, width=self.width,
                             in_channels=(128, 256, 512), act="lrelu",
                             name="head")(fpn, train), fpn

    return JYOLOv3At(num_classes=num_classes)


def torch_yolov3(depth: int, num_classes: int):
    """The port's YOLOv3 over Darknet ``depth`` (its own class is 53)."""
    model = YOLOv3(num_classes=num_classes)
    model.backbone = YOLOFPN(depth)
    return model


# ---------------------------------------------------------------- blocks

BLOCKS = {
    # name: (JAX module, port module for 8 input channels)
    "grouped": (lambda: jblocks.BaseConv(8, 3, 2, groups=8),
                lambda pc: tblocks.BaseConv(8, 8, 3, 2, groups=8)),
    "dwconv": (lambda: jblocks.DWConv(16, 3, 2),
               lambda pc: tblocks.DWConv(8, 16, 3, 2, phase_conv=pc)),
    "reslayer": (lambda: jblocks.ResLayer(),
                 lambda pc: tblocks.ResLayer(8, phase_conv=pc)),
}


@pytest.mark.parametrize("phase_conv", [False, True])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_eval_train_and_gradients_match_jax(name, phase_conv):
    """Eval output, then two train-mode steps (outputs and BatchNorm
    running statistics), then the gradients of a weighted sum with respect
    to the input and every parameter: 1e-5 of each tensor's scale.  With
    ``phase_conv`` the 1x1 / 3x3 convs take the kernel's plain version."""
    jmake, tmake = BLOCKS[name]
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    jmod = jmake()
    variables = random_variables(jmod, jnp.asarray(x))
    tmod = tmake(phase_conv)
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))

    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1).numpy(), japply(jmod, variables, x),
          "eval")

    tmod.train()
    stats = variables["batch_stats"]
    train = jax.jit(lambda v, xx: jmod.apply(v, xx, True,
                                             mutable=["batch_stats"]))
    for i in range(2):
        xi = x + i
        want, mut = train({"params": variables["params"],
                           "batch_stats": stats}, xi)
        stats = mut["batch_stats"]
        got = tmod(torch.from_numpy(xi).permute(0, 3, 1, 2))
        close(got.detach().permute(0, 2, 3, 1).numpy(), want, f"train {i}")
    want_sd = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, stats)})
    sd = tmod.state_dict()
    for k, v in want_sd.items():
        if v.is_floating_point():
            close(sd[k].numpy(), v.numpy(), k)

    cot = rng.randn(*np.asarray(want).shape).astype(np.float32)

    def loss(params, xx):
        y, _ = jmod.apply({"params": params, "batch_stats": stats}, xx, True,
                          mutable=["batch_stats"])
        return jnp.sum(y * cot)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"],
                                                     jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    tmod.zero_grad()
    (tmod(xt) * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    close(xt.grad.permute(0, 2, 3, 1).numpy(), gx, "dx")
    want_g = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, gp)})
    for n, p in tmod.named_parameters():
        close(p.grad.numpy(), want_g[n].numpy(), f"grad {n}")


def test_grouped_conv_never_takes_the_kernel():
    with pytest.raises(ValueError, match="ungrouped"):
        tblocks.BaseConv(8, 8, 3, groups=8, phase_conv=True)
    dw = tblocks.DWConv(8, 16, 3, 2, phase_conv=True)
    assert not dw.dconv.phase_conv and dw.pconv.phase_conv
    assert dw.dconv.conv.weight.shape == (8, 1, 3, 3)


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("depth", [21, 53])
def test_darknet_taps_match_jax(depth):
    """Darknet's dark3 / dark4 / dark5 taps (256 / 512 / 512 channels) at
    64 px; ten convs take phase_conv at depth 53, eight at 21 (one
    ResLayer less in dark2)."""
    x = image()
    jmod = JDarknet(depth)
    variables = random_variables(jmod, jnp.asarray(x), seed=depth)
    tmod = Darknet(depth).eval()
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    want = japply(jmod, variables, x)
    with torch.no_grad():
        got = tmod(nchw(x))
    names = ("dark3", "dark4", "dark5")
    assert_maps([got[n] for n in names], [want[n] for n in names],
                what=f"darknet{depth}")
    assert [got[n].shape[1] for n in names] == [256, 512, 512]
    kernel = [n for n, m in tmod.named_modules()
              if isinstance(m, tblocks.BaseConv) and m.phase_conv]
    assert len(kernel) == {21: 8, 53: 10}[depth] and kernel[0] == "stem.0"
    assert kernel[-1] == "dark3.0"


def test_yolov3_and_yolofpn_match_jax():
    """The whole YOLOv3 (YOLOFPN + the lrelu head) over Darknet-21 at 64 px,
    B=1 (Darknet-53 is held alone above: its whole-model compile costs
    twice as much): the neck's three maps (128 / 256 / 512 channels) and
    the head's maps within 1e-4."""
    x = image()
    jmod = jax_yolov3(21, CLASSES)
    variables = random_variables(jmod, jnp.asarray(x), seed=53)
    heads, fpn = japply(jmod, variables, x)
    model = torch_yolov3(21, CLASSES).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got_heads, got_fpn = model(nchw(x))
    assert_maps(got_fpn, fpn, what="yolofpn")
    assert [f.shape[1] for f in got_fpn] == [128, 256, 512]
    assert_maps(got_heads, heads, what="head")
    assert got_heads[0].shape[1] == 4 + 1 + CLASSES


def test_nano_structure_matches_jax():
    """YOLOX at YOLOX-Nano's structure (depth 0.33, width 0.25, DWConv in
    backbone, neck and head): head maps within 1e-4, and the port's exp
    builds the same module tree."""
    x = image(2)
    jmod = JYOLOX(depth=0.33, width=0.25, num_classes=CLASSES,
                  depthwise=True, packed_early=False)
    variables = random_variables(jmod, jnp.asarray(x), seed=7)
    want, _ = japply(jmod, variables, x)
    exp = Exp()
    exp.depth, exp.width, exp.depthwise = 0.33, 0.25, True
    exp.num_classes = CLASSES
    model = exp.get_model("cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got, _ = model(nchw(x))
    assert_maps(got, want, what="nano head")
    kernel = [n for n, m in model.named_modules()
              if isinstance(m, tblocks.BaseConv) and m.phase_conv]
    assert len(kernel) == 8
    assert "backbone.backbone.dark2.0.pconv" in kernel
    assert "backbone.backbone.dark3.0.pconv" in kernel


# ---------------------------------------------------------------- bridge

@pytest.mark.parametrize("depth", [21, 53])
def test_yolov3_keys_round_trip_through_map_yolofpn_key(depth):
    """Every key of the port's YOLOv3 (Darknet ``depth``) maps to a flax
    path of eop_tpu's YOLOv3 variables through eop_tpu's
    ``map_yolofpn_key``, and back through the port's inverse; the
    variables load into the port strictly and bit for bit."""
    shapes = jax.eval_shape(lambda: jax_yolov3(depth, CLASSES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), False))
    # every value distinct (a transposed or swapped tensor shows), cheaply
    count = iter(range(1 << 20))
    variables = jax.tree_util.tree_map(
        lambda v: (np.arange(np.prod(v.shape), dtype=np.float32) * 1e-6
                   + next(count)).reshape(v.shape), dict(shapes))
    flax_paths = set()
    for coll in ("params", "batch_stats"):
        flax_paths |= {".".join(p[:-1]) for p in _leaf_paths(
            variables[coll])}
    model = torch_yolov3(depth, CLASSES)
    sd = state_dict_from_jax(variables)
    model.load_state_dict(sd, strict=True)
    n_res = {21: 1, 53: 4}[depth]
    prefixes = {k.rsplit(".", 1)[0] for k in model.state_dict()}
    for prefix in prefixes:
        mapped = map_yolofpn_key(prefix + ".weight", depth)
        path = mapped.rsplit(".", 1)[0]
        assert path in flax_paths, (prefix, mapped)
        assert unmap_yolofpn_key(path, n_res) == prefix
    # and the JAX package's importer reads the port's state_dict back
    back = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        key_mapper=lambda k: map_yolofpn_key(k, depth))
    for coll in ("params", "batch_stats"):
        for path, v in _leaf_items(variables[coll]):
            node = back[coll]
            for p in path[:-1]:
                node = node[p]
            np.testing.assert_array_equal(node[path[-1]], v, err_msg=path)
    # the SPP block follows dark5's stride conv and its ResLayers
    assert f"backbone.backbone.dark5.{n_res + 3}.conv1.conv" in prefixes


def test_nano_variables_load_with_dwconv_names():
    """Nano's JAX variables (``dconv`` / ``pconv``, grouped kernels ``[3, 3,
    1, C]``) load strictly; a grouped kernel arrives as ``[C, 1, 3, 3]``."""
    jmod = JYOLOX(depth=0.33, width=0.25, num_classes=CLASSES,
                  depthwise=True, packed_early=False)
    variables = random_variables(jmod, jnp.zeros((1, SIZE, SIZE, 3)))
    sd = state_dict_from_jax(variables)
    model = YOLOX(depth=0.33, width=0.25, num_classes=CLASSES, depthwise=True)
    model.load_state_dict(sd, strict=True)
    k = variables["params"]["backbone"]["backbone"]["dark2_conv"]["dconv"][
        "conv"]["kernel"]
    w = sd["backbone.backbone.dark2.0.dconv.conv.weight"]
    assert k.shape == (3, 3, 1, 16) and tuple(w.shape) == (16, 1, 3, 3)
    np.testing.assert_array_equal(w.numpy(), k.transpose(3, 2, 0, 1))


def _leaf_items(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaf_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf_paths(tree):
    return [p for p, _ in _leaf_items(tree)]
