"""The feature-map study's backbones in the port against the JAX package's:
VGG19, the half-width ResNet50 and DenseNet121 alone and under YOLOX at
depth 0.33, width 0.25 (the neck narrower than the backbone's fixed 256 /
512 / 1024 taps) and width 1.0, eval mode in fp32 (the 6-tuple and the head
maps; the JAX variables carried across with ``strict=True``); one bbox
training step in fp32 (assignment, loss, gradients by norm) and in float64
(each gradient, the BatchNorm running statistics); DenseNet's channel
dropout (its statistics, its generator, a ``remat`` step equal to a plain
one, and a resumed run drawing an uninterrupted one's masks); the exp's
``backbone_type``; ``get_model_info``'s parameter count and the weight
decay groups against ``eop_tpu``'s.

3 classes, 64 px, B <= 2.  The JAX variables are random numpy trees of the
shapes ``init`` gives (BatchNorm away from the identity; see
``tests/test_torch_zoo_models.py``); each backbone's JAX side compiles once
per use (eval at each width, the fp32 step, the float64 step) and the
tests share it.  DenseNet's training cases build it with ``drop_rate=0.0``
on both sides (JAX's dropout draws from a flax RNG stream the port does
not reproduce)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

from eop_tpu.losses import YoloxLossConfig as JLossConfig
from eop_tpu.losses import simota as jsimota
from eop_tpu.models import YOLOX as JYOLOX
from eop_tpu.models import inference_outputs as j_inference_outputs
from eop_tpu.models import training_outputs as j_training_outputs
from eop_tpu.models import pafpn as jpafpn
from eop_tpu.models.densenet import densenet121 as j_densenet121
from eop_tpu.models.resnet import resnet50 as j_resnet50
from eop_tpu.models.vgg import vgg19 as j_vgg19
from eop_tpu_torch.exp import Exp
from eop_tpu_torch.losses import YoloxLossConfig
from eop_tpu_torch.losses import simota as tsimota
from eop_tpu_torch.models.densenet import (
    ChannelDropout,
    DenseNet,
    densenet121,
)
from eop_tpu_torch.models.pafpn import BACKBONE_TYPES
from eop_tpu_torch.models.resnet import resnet50
from eop_tpu_torch.models.vgg import vgg19
from eop_tpu_torch.models.yolox import (
    YOLOX,
    dropouts,
    inference_outputs,
    training_outputs,
)
from eop_tpu_torch.train.optimizer import build_sgd
from eop_tpu_torch.train.steps import make_train_step_bbox
from eop_tpu_torch.utils.weights import (
    state_dict_from_jax,
    train_state_from_jax,
)
from test_torch_zoo_models import assert_maps, japply, nchw, random_variables

SIZE, BATCH, CLASSES = 64, 2, 3
LR, MOMENTUM, WEIGHT_DECAY, EMA_DECAY = 1e-3, 0.9, 5e-4, 0.9998
BACKBONES = {
    # JAX backbone, the port's, both at drop_rate 0 for DenseNet
    "vgg": (lambda: j_vgg19(), lambda: vgg19()),
    "resnet": (lambda: j_resnet50(), lambda: resnet50()),
    "densenet": (lambda: j_densenet121(drop_rate=0.0),
                 lambda: densenet121(drop_rate=0.0)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(batch=1, seed=1):
    return np.random.RandomState(seed).uniform(
        0, 255, (batch, SIZE, SIZE, 3)).astype(np.float32)


def labels(seed=2):
    """[B, 50, 5] rows (cls, cx, cy, w, h), 4 boxes an image."""
    rng = np.random.RandomState(seed)
    out = np.zeros((BATCH, 50, 5), np.float32)
    for b in range(BATCH):
        for g in range(4):
            w, h = rng.uniform(10, 30, 2)
            out[b, g] = (rng.randint(CLASSES), rng.uniform(w, SIZE - w),
                         rng.uniform(h, SIZE - h), w, h)
    return out


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def jax_yolox(backbone, depth=1.0, width=1.0):
    return JYOLOX(backbone_type=backbone, depth=depth, width=width,
                  num_classes=CLASSES, packed_early=False)


def port_yolox(backbone, depth=1.0, width=1.0):
    model = YOLOX(depth, width, num_classes=CLASSES, backbone_type=backbone)
    if backbone == "densenet":
        model.backbone.backbone = densenet121(
            out_features=("dark3", "dark4", "dark5"), drop_rate=0.0)
    return model


@pytest.fixture
def densenet_without_dropout(monkeypatch):
    """eop_tpu's YOLOPAFPN builds DenseNet121 with drop_rate 0.3; the
    training cases build it with 0."""
    monkeypatch.setattr(jpafpn, "densenet121",
                        lambda **kw: j_densenet121(drop_rate=0.0, **kw))


def to_float64(model):
    """The port's module in float64: parameters, buffers and every
    module's compute ``dtype``."""
    model = model.double()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return model


@functools.lru_cache(maxsize=None)
def jax_eval(name, width):
    """eop_tpu's YOLOX over ``name`` at depth 0.33 and ``width`` in eval
    mode, one compile each: (numpy variables of the shapes ``init`` gives,
    head maps, 6-tuple)."""
    x = images()
    jmod = jax_yolox(name, 0.33, width)
    variables = random_variables(jmod, jnp.asarray(x))
    heads, fpn = japply(jmod, variables, x)
    return variables, [np.asarray(h) for h in heads], [np.asarray(f)
                                                      for f in fpn]


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_alone_matches_jax(name):
    """The port's backbone alone, loaded (``strict=True``) from the
    backbone's part of eop_tpu's YOLOX variables: its (dark3, dark4, dark5)
    taps in eval mode within 1e-4 of the largest value of eop_tpu's
    (x2, x1, x0), 256 / 512 / 1024 channels."""
    variables, _, want = jax_eval(name, 0.25)
    sub = {c: variables[c]["backbone"]["backbone"]
           for c in ("params", "batch_stats")}
    tmod = BACKBONES[name][1]()
    tmod.load_state_dict(state_dict_from_jax(sub), strict=True)
    assert tmod.out_channels == (256, 512, 1024)
    with torch.no_grad():
        got = tmod.eval()(nchw(images()))
    assert_maps([got[k] for k in ("dark3", "dark4", "dark5")], want[3:],
                what=f"{name} alone")


@pytest.mark.parametrize("width", [0.25, 1.0])
@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_yolox_over_backbone_matches_jax(name, width):
    """YOLOX(backbone_type=name) at depth 0.33, eval mode: eop_tpu's
    variables exported by the bridge and loaded with ``strict=True``; the
    6-tuple (FPN maps at the neck's width, taps at 256 / 512 / 1024: at
    width 0.25 the neck's input channels differ from ``width``'s) and the
    head maps within 1e-4 of each output's largest value."""
    variables, want_heads, want_fpn = jax_eval(name, width)
    tmod = YOLOX(0.33, width, num_classes=CLASSES, backbone_type=name)
    loaded = tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert not loaded.missing_keys and not loaded.unexpected_keys
    with torch.no_grad():
        heads, fpn = tmod.eval()(nchw(images()))
    assert [t.shape[1] for t in fpn[3:]] == [256, 512, 1024]
    assert fpn[0].shape[1] == int(256 * width)
    assert_maps(fpn, want_fpn, what=f"{name} fpn")
    assert_maps(heads, want_heads, what=f"{name} head")
    want = np.asarray(j_inference_outputs(want_heads))
    got = inference_outputs(heads).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def rel_l2(got, want):
    """The relative L2 distance of two gradient dicts taken whole."""
    num = sum(((got[k] - w) ** 2).sum().item() for k, w in want.items())
    den = sum((w ** 2).sum().item() for w in want.values())
    return (num / den) ** 0.5


def jax_losses(jmod, variables, imgs, lab, dtype=jnp.float32):
    """eop_tpu's train-mode forward, decode and bbox loss as one function
    of the params: (total, (aux, assignment, updated batch statistics))."""
    from eop_tpu.losses import yolox_loss as jyl

    cfg = JLossConfig(num_classes=CLASSES)
    stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                   variables["batch_stats"])

    def run(params):
        (heads, _), upd = jmod.apply(
            {"params": params, "batch_stats": stats},
            jnp.asarray(imgs, dtype), True, mutable=["batch_stats"])
        dec, origin, grids, strides = j_training_outputs(heads)
        total, aux = jyl.yolox_losses(dec, origin, jnp.asarray(lab), grids,
                                      strides, cfg)
        d = dec.astype(jnp.float32)
        assign = jax.vmap(lambda lb, bp, ol, cl: jsimota.simota_assign(
            lb, bp, ol, cl, grids.astype(jnp.float32),
            strides.astype(jnp.float32), CLASSES, jsimota.SimOTAConfig()))(
                jnp.asarray(lab), d[..., :4], d[..., 4], d[..., 5:])
        return total, (aux, assign, upd["batch_stats"])

    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                    variables["params"])
    return run, params


def jax_model(name, variables, dtype):
    """eop_tpu's step function of the params in ``dtype`` (see
    :func:`jax_losses`) on the step tests' batch."""
    jmod = JYOLOX(backbone_type=name, depth=0.33, width=0.25,
                  num_classes=CLASSES, packed_early=False, dtype=dtype)
    return jax_losses(jmod, variables, images(BATCH, seed=3), labels(),
                      dtype)


@functools.lru_cache(maxsize=None)
def jax_step64(name):
    """eop_tpu's float64 gradients and the BatchNorm statistics its
    train-mode forward leaves, as state dicts: one compile under
    ``jax.enable_x64``, shared by both step tests."""
    variables = jax_eval(name, 0.25)[0]
    with jax.enable_x64(True):
        run, params = jax_model(name, variables, jnp.float64)
        (_, (_, _, stats)), grads = jax.jit(jax.value_and_grad(
            run, has_aux=True))(params)
        grads = state_dict_from_jax({"params": to_np(grads)})
        stats = state_dict_from_jax({"params": variables["params"],
                                     "batch_stats": to_np(stats)})
    return stats, grads


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_one_step_matches_jax(name, densenet_without_dropout):
    """One fp32 bbox training step of YOLOX(width 0.25) over the backbone
    from one state, the port's make_train_step_bbox against eop_tpu's
    train-mode forward, decode and loss: the SimOTA assignment equal (the
    foreground mask and every matched GT; assigned again from the port's
    train-mode outputs), the loss and its parts 1e-4 relative with an
    equal foreground count, and the step's gradients (its first momentum,
    less the weight decay) within 2.5e-2 of eop_tpu's float64 ones by
    their norm (measured: 7e-3 to 9e-3).  In fp32 a gradient is not held
    per tensor: batch statistics of two 64 px images (8 values a channel
    at dark5) amplify rounding through 50-120 BatchNorms, on either side;
    the float64 case below holds each tensor.  eop_tpu's float64
    gradients are the reference here, not its fp32 ones: they are closer
    to the exact gradient than either package's fp32, and their compile
    is the float64 case's."""
    imgs, lab = images(BATCH, seed=3), labels()
    variables = jax_eval(name, 0.25)[0]
    run, params = jax_model(name, variables, jnp.float32)
    jtotal, (jaux, want, _) = jax.jit(run)(params)

    tmodel = port_yolox(name, 0.33, 0.25).to(
        memory_format=torch.channels_last).train()
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        heads, _ = tmodel(nchw(imgs))
        dec, _, grids, strides = training_outputs(heads)
        got = tsimota.simota_assign(
            torch.from_numpy(lab), dec[..., :4], dec[..., 4], dec[..., 5:],
            grids, strides, CLASSES, tsimota.SimOTAConfig())
    np.testing.assert_array_equal(got.fg_mask.numpy(),
                                  np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.matched_gt.numpy(),
                                  np.asarray(want.matched_gt))
    assert got.fg_mask.sum() > 0

    tmodel = port_yolox(name, 0.33, 0.25).to(
        memory_format=torch.channels_last).train()
    opt = build_sgd(tmodel, LR, momentum=MOMENTUM,
                    weight_decay=WEIGHT_DECAY, nesterov=True)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    state = train_state_from_jax(
        {**variables, "momentum": zeros, "ema_params": variables["params"],
         "ema_batch_stats": variables["batch_stats"], "step": 0},
        tmodel, opt)
    tstep = make_train_step_bbox(YoloxLossConfig(num_classes=CLASSES),
                                 ema_decay=EMA_DECAY)
    state, tm = tstep(state, torch.from_numpy(imgs), torch.from_numpy(lab))
    for k, w in (("total_loss", jtotal), ("iou_loss", jaux.loss_iou),
                 ("conf_loss", jaux.loss_obj), ("cls_loss", jaux.loss_cls),
                 ("l1_loss", jaux.loss_l1), ("num_fg", jaux.num_fg_per_gt)):
        np.testing.assert_allclose(tm[k].item(), float(w), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert tm["num_fg"].item() == float(jaux.num_fg_per_gt) > 0

    p0 = state_dict_from_jax({"params": variables["params"]})
    grads = {k: (opt.state[p]["momentum_buffer"] - (
        WEIGHT_DECAY * p0[k] if p.dim() == 4 else 0.0)).double()
        for k, p in state.model.named_parameters()}
    jgrads = jax_step64(name)[1]
    assert set(grads) == set(jgrads)
    assert rel_l2(grads, jgrads) <= 2.5e-2


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_float64_step_matches_jax(name, densenet_without_dropout):
    """The same batch in float64 on both sides (eop_tpu under
    ``jax.enable_x64`` with ``dtype=float64``, the port's model
    ``.double()``; both losses still upcast to fp32): each gradient tensor
    within 1e-5 of its largest value (measured: 1.4e-7), and the BatchNorm
    running statistics the train-mode forward leaves within 1e-6."""
    from eop_tpu_torch.losses.yolox_loss import yolox_losses

    imgs, lab = images(BATCH, seed=3), labels()
    variables = jax_eval(name, 0.25)[0]
    jstats, jgrads = jax_step64(name)

    model = port_yolox(name, 0.33, 0.25).train()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model = to_float64(model)
    heads, _ = model(nchw(imgs).double())
    dec, origin, grids, strides = training_outputs(heads)
    loss, _ = yolox_losses(dec, origin, torch.from_numpy(lab).double(),
                           grids, strides,
                           YoloxLossConfig(num_classes=CLASSES))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    for k, w in jgrads.items():
        w = w.double()
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max().item() + 1e-30,
                                   err_msg=k)
    sd = model.state_dict()
    running = [k for k in jstats if "running" in k]
    assert len(running) > 100
    for k in running:
        v = jstats[k]
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6 * v.abs().max().item(),
                                   err_msg=k)


def recording_masks(monkeypatch):
    """Every keep mask ChannelDropout draws from now on, in order."""
    masks = []
    draw = ChannelDropout.keep_mask

    def keep_mask(self, shape, device):
        masks.append(draw(self, shape, device))
        return masks[-1]

    monkeypatch.setattr(ChannelDropout, "keep_mask", keep_mask)
    return masks


def test_densenet_dropout_masks_statistics_and_generator(monkeypatch):
    """Channel dropout at 0.3 in training: each (sample, channel) of a dense
    layer's output kept or zeroed whole, kept values scaled by 1 / 0.7,
    about 70 % kept; the same seed draws the same masks, another seed
    others; eval mode draws none and leaves the global RNG alone."""
    masks = recording_masks(monkeypatch)
    torch.manual_seed(0)
    model = DenseNet(block_layers=(2, 2, 2, 2), drop_rate=0.3).train()
    layer = model.D1.denseblock[0]
    x = torch.from_numpy(images(BATCH)).permute(0, 3, 1, 2) / 255
    stem = model.stem(x)
    global_state = torch.get_rng_state()
    model.dropout.reseed(5)
    y = layer(stem)
    model.dropout.reseed(5)
    layer.dropout = None
    plain = layer(stem)
    layer.dropout = model.dropout
    assert torch.equal(torch.get_rng_state(), global_state)
    kept = (y != 0).flatten(2).any(-1)
    scaled = torch.where(kept[..., None, None], plain / 0.7,
                         torch.zeros(()))
    torch.testing.assert_close(y, scaled, rtol=1e-6, atol=1e-7)
    assert len(masks) == 1 and torch.equal(masks[0].flatten(1), kept)

    many = DenseNet(drop_rate=0.3)
    many.dropout.reseed(1)
    masks.clear()
    feats = many.train()(x)
    drawn = torch.cat([m.flatten() for m in masks])
    assert len(masks) == 58 and drawn.numel() == 58 * 32 * BATCH
    assert abs(drawn.float().mean().item() - 0.7) < 0.05
    assert all(torch.isfinite(v).all() for v in feats.values())
    many.dropout.reseed(1)
    again = many(x)
    many.dropout.reseed(2)
    other = many(x)
    assert torch.equal(again["dark5"], feats["dark5"])
    assert not torch.equal(other["dark5"], feats["dark5"])
    masks.clear()
    with torch.no_grad():
        many.eval()(x)
    assert not masks


def test_resumed_densenet_run_draws_the_uninterrupted_masks(
        tmp_path, monkeypatch):
    """``tools.train`` over DenseNet, one step an epoch: a run resumed after
    its first epoch draws, in its second step, the masks that step draws
    in an uninterrupted two-epoch run (the trainer seeds the generator from
    the exp's seed and the global step); the two steps' masks differ."""
    from eop_tpu_torch.tools import train as train_cli
    from eop_tpu_torch.utils.synth import write_coco_dataset

    data = write_coco_dataset(str(tmp_path / "coco"), BATCH, 1, (64, 64),
                              num_classes=CLASSES, seed=3)
    masks = recording_masks(monkeypatch)

    def run(out, epochs, *extra):
        masks.clear()
        train_cli.main(
            ["-n", "yolox-s", "-b", str(BATCH), "--data-dir", data,
             "--device", "cpu", *extra, "depth", "0.33", "width", "0.25",
             "num_classes", str(CLASSES), "input_size", "(64,64)",
             "test_size", "(64,64)", "backbone_type", "densenet",
             "data_num_workers", "0", "multiscale_range", "0",
             "eval_interval", "10", "no_aug_epochs", "0", "max_epoch",
             str(epochs), "output_dir", str(tmp_path / out)])
        return [m.clone() for m in masks]

    whole = run("whole", 2)
    assert len(whole) == 2 * 58
    run("split", 1)
    resumed = run("split", 2, "--resume")
    assert len(resumed) == 58
    assert all(torch.equal(a, b) for a, b in zip(resumed, whole[58:]))
    assert not all(torch.equal(a, b) for a, b in zip(whole[:58], whole[58:]))


def test_densenet_remat_step_equals_plain():
    """YOLOX over DenseNet (dropout 0.3): a ``remat`` training step (the
    backbone + neck recomputed in the backward, its masks drawn again from
    the generator state the forward started from) gives the plain step's
    head maps and gradients within 1e-6 relative, and leaves the generator
    where the plain step leaves it."""
    exp = Exp()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, CLASSES
    exp.backbone_type = "densenet"
    x = nchw(images(BATCH, seed=4))
    out = {}
    for remat in (False, True):
        exp.remat = remat
        model = exp.get_model("cpu", seed=7).train()
        assert model.remat == remat
        heads, _ = model(x)
        loss = sum((h.float() * torch.linspace(-1, 1, h.numel()).reshape(
            h.shape)).sum() for h in heads)
        loss.backward()
        (d,) = dropouts(model)
        out[remat] = ([h.detach() for h in heads],
                      {k: p.grad for k, p in model.named_parameters()},
                      torch.rand(4, generator=d.generator("cpu")))
    for a, b in zip(out[False][0], out[True][0]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6 * a.abs().max())
    grads, rgrads = out[False][1], out[True][1]
    assert set(grads) == set(rgrads)
    for k, g in grads.items():
        torch.testing.assert_close(rgrads[k], g, rtol=0,
                                   atol=1e-6 * g.abs().max() + 1e-30,
                                   msg=k)
    assert torch.equal(out[False][2], out[True][2])


def test_exp_builds_each_backbone_and_seeds_its_dropout():
    """``get_model(backbone_type=...)`` overrides ``exp.backbone_type``;
    DenseNet's dropout generator takes the model seed."""
    exp = Exp()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, CLASSES
    assert BACKBONE_TYPES == tuple(jpafpn.BACKBONE_TYPES)
    for name in BACKBONE_TYPES:
        model = exp.get_model("cpu", backbone_type=name)
        assert type(model.backbone.backbone).__name__ == {
            "darknet": "CSPDarknet", "vgg": "VGG", "resnet": "ResNet",
            "densenet": "DenseNet"}[name]
    (d,) = dropouts(exp.get_model("cpu", seed=11, backbone_type="densenet"))
    assert (d.p, d.seed) == (0.3, 11)
    exp.backbone_type = "resnet"
    assert type(exp.get_model("cpu").backbone.backbone).__name__ == "ResNet"


@functools.lru_cache(maxsize=None)
def param_shapes(name):
    """The ``params`` shapes of eop_tpu's YOLOX(0.33, 0.25) over ``name``
    (traced once, not compiled)."""
    jmod = jax_yolox(name, 0.33, 0.25)
    return jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), False))["params"]


@pytest.mark.parametrize("name", ["darknet", "vgg", "resnet", "densenet"])
def test_model_info_params_match_eop_tpu(name):
    """get_model_info's parameter count (the JAX variables' ``params``) is
    eop_tpu's exactly; its MACs at batch 1 are positive."""
    from eop_tpu_torch.utils.model_utils import count_params, get_model_info

    want = sum(int(np.prod(v.shape))
               for v in jax.tree_util.tree_leaves(param_shapes(name)))
    model = YOLOX(0.33, 0.25, num_classes=CLASSES, backbone_type=name)
    assert count_params(model) == want
    info = get_model_info(model, (SIZE, SIZE))
    assert info.startswith(f"Params: {want / 1e6:.2f}M, Gflops: ")
    assert float(info.rsplit(" ", 1)[1]) > 0


@pytest.mark.parametrize("name", ["vgg", "resnet", "densenet"])
def test_weight_decay_groups_match_eop_tpu(name):
    """The exp's optimizer decays exactly the parameters eop_tpu's mask
    decays (every conv ``kernel``, the backbones' included), and no
    BatchNorm scale or bias."""
    from eop_tpu_torch.utils.weights import unmap_key

    flat = jax.tree_util.tree_flatten_with_path(param_shapes(name))[0]
    want = {unmap_key(".".join(k.key for k in path[:-1])) + ".weight"
            for path, _ in flat if path[-1].key == "kernel"}
    exp = Exp()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, CLASSES
    model = exp.get_model("cpu", backbone_type=name)
    opt = exp.get_optimizer(model, BATCH)
    names = {id(p): k for k, p in model.named_parameters()}
    decayed = {names[id(p)] for g in opt.param_groups if g["weight_decay"] > 0
               for p in g["params"]}
    assert decayed == want and len(want) > 50
