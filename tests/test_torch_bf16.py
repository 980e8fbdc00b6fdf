"""bf16 compute (``compute_dtype``) and gradient checkpointing (``remat``) of
the port's 24p model against the JAX package's ``YOLOX(dtype=jnp.bfloat16)``
and its own fp32 path, with JAX-initialised weights carried across by
``state_dict_from_jax``; 24p-s depth, width 0.25, 64 px, batch 2.

Tolerances are relative to the largest value of the output compared.  bf16
keeps 8 bits of mantissa (an ulp is 0.4-0.8 % of a value), and the two
packages round at different points inside a layer: the port's fused
eval-mode epilogue rounds once after conv + BatchNorm + SiLU where JAX
rounds after each, XLA's bf16 SiLU is not torch's, and the differences grow
through about a hundred layers.  Everything downstream of the head maps
(decode, postprocess, loss) is held on shared inputs, where both packages
see the same bf16 numbers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.eval import postprocess as jpp
from eop_tpu.losses import DWAState as JDWAState
from eop_tpu.losses import Loss24PConfig as JLossConfig
from eop_tpu.losses import loss_24p as j_loss_24p
from eop_tpu.losses import simota_assign_24p as j_assign
from eop_tpu.models import YOLOX as JYOLOX
from eop_tpu.models import init_model
from eop_tpu.models import inference_outputs as j_inference_outputs
from eop_tpu.models.yolox import training_outputs as j_training_outputs
from eop_tpu_torch.eval import postprocess as pp
from eop_tpu_torch.exp import Exp24P
from eop_tpu_torch.losses import DWAState, Loss24PConfig, loss_24p
from eop_tpu_torch.losses import simota_assign_24p
from eop_tpu_torch.models.yolox import YOLOX, inference_outputs
from eop_tpu_torch.models.yolox import training_outputs
from eop_tpu_torch.ops import phase_conv as pc
from eop_tpu_torch.train.steps import create_train_state, make_train_step_24p
from eop_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_models import nchw, perturbed


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (tests/test_torch_bbox_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE, BATCH, CLASSES = 64, 2, 3
MODEL = dict(depth=0.33, width=0.25, num_classes=CLASSES, reg_dim=26)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
M = 50  # label rows per image


def to_np(t):
    return np.array(jnp.asarray(t).astype(jnp.float32))


def heads_np(heads):
    """Port head maps (NCHW) as float32 NHWC numpy."""
    return [h.detach().permute(0, 2, 3, 1).float().numpy() for h in heads]


def rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def make_labels(seed, batch=BATCH, ngt=3, r_lo=8.0, r_hi=20.0, size=SIZE):
    """[B, M, 51] rows (cls, cx, cy, 24 x (x, y)) of star polygons."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((batch, M, 51), np.float32)
    theta = np.arange(24) * (2 * np.pi / 24)
    for b in range(batch):
        for g in range(ngt):
            cx, cy = rng.uniform(r_hi, size - r_hi, 2)
            r = rng.uniform(r_lo, r_hi, 24)
            labels[b, g, 0] = rng.randint(CLASSES)
            labels[b, g, 1:3] = cx, cy
            labels[b, g, 3::2] = cx + r * np.cos(theta)
            labels[b, g, 4::2] = cy + r * np.sin(theta)
    return labels


@pytest.fixture(scope="module")
def common():
    """JAX models in both dtypes over one perturbed state (the packed early
    layout off: the port has none), that state as a port state_dict, and a
    seeded batch."""
    jmodels = {k: JYOLOX(**MODEL, packed_early=False, dtype=jdt)
               for k, (jdt, _) in DTYPES.items()}
    variables = perturbed(init_model(jmodels["float32"],
                                     jax.random.PRNGKey(0),
                                     jnp.zeros((1, SIZE, SIZE, 3))))
    x = np.random.RandomState(3).uniform(0, 255, (BATCH, SIZE, SIZE, 3)
                                         ).astype(np.float32)
    return jmodels, variables, state_dict_from_jax(variables), x


def port_model(sd, dtype, **kw):
    model = YOLOX(**MODEL, dtype=dtype, **kw)
    model.load_state_dict(sd, strict=True)
    return model.to(memory_format=torch.channels_last).eval()


def jax_eval_heads(jmodel, variables, x):
    heads, _ = jax.jit(lambda v, im: jmodel.apply(v, im, False))(
        variables, jnp.asarray(x))
    return heads


# ------------------------------------------------------------ the forward

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_eval_head_maps_match_jax(common, dtype, tol):
    """Eval-mode head maps (fused epilogue on the early convs): fp32 within
    1e-4 (measured 9e-7); bf16 within 2e-2 of each map's largest value
    (measured 1.2e-2, under 3 bf16 ulps of it), in bf16."""
    jmodels, variables, sd, x = common
    want = jax_eval_heads(jmodels[dtype], variables, x)
    model = port_model(sd, DTYPES[dtype][1])
    with torch.no_grad():
        heads, fpn = model(nchw(x))
    assert {h.dtype for h in (*heads, *fpn)} == {DTYPES[dtype][1]}
    for i, (g, w) in enumerate(zip(heads_np(heads), want)):
        assert w.dtype == DTYPES[dtype][0]
        assert rel_err(g, to_np(w)) <= tol, (i, rel_err(g, to_np(w)))


def test_bf16_path_against_the_fp32_path(common):
    """The port's bf16 eval head maps against its fp32 ones: within 3e-2 of
    each map's largest value (measured 1.2e-2); parameters stay fp32."""
    _, _, sd, x = common
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        model = port_model(sd, dt)
        assert {p.dtype for p in model.state_dict().values()
                if p.is_floating_point()} == {torch.float32}
        with torch.no_grad():
            out[dt] = heads_np(model(nchw(x))[0])
    for i, (g, w) in enumerate(zip(out[torch.bfloat16], out[torch.float32])):
        assert rel_err(g, w) <= 3e-2, (i, rel_err(g, w))


@pytest.mark.parametrize("act", ["silu", "relu"])
def test_bf16_eval_fused_path_against_the_unfused_path(common, act):
    """Eval mode without autograd fuses BN + SiLU into the early convs'
    epilogue (one rounding to bf16); with autograd on, the same model runs
    conv -> BN -> act as modules (three roundings, as JAX).  SiLU: within
    2e-2 of each map's largest value (measured 1.2e-2); relu never fuses,
    so both paths are the same computation and the same bits."""
    _, _, sd, x = common
    model = YOLOX(**MODEL, dtype=torch.bfloat16, act=act)
    model.load_state_dict(sd, strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        fused = heads_np(model(nchw(x))[0])
    early = [m for m in model.modules() if getattr(m, "phase_conv", False)]
    assert len(early) == 8
    assert all((m._bn_cache[1] is not None) == (act == "silu") for m in early)
    with torch.enable_grad():
        unfused = heads_np(model(nchw(x))[0])
    for g, w in zip(fused, unfused):
        if act == "relu":
            np.testing.assert_array_equal(g, w)
        else:
            assert rel_err(g, w) <= 2e-2, rel_err(g, w)


def test_focus_weight_is_folded_in_fp32_then_cast(common):
    """The stem's kernel weight: the fp32 fold of the Focus kernel, then one
    cast to bf16 (JAX's order), not a fold of the bf16 kernel."""
    _, _, sd, _ = common
    from eop_tpu_torch.ops.blocks import fold_focus_weight

    stem = port_model(sd, torch.bfloat16).backbone.backbone.stem.conv
    w = stem.conv.weight
    want = fold_focus_weight(w).to(torch.bfloat16)
    with torch.no_grad():
        got, _, _ = stem._hwio_args()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.permute(2, 3, 1, 0))


# ------------------------------------------------------- decode, postprocess

def rand_heads(seed, dtype, batch=3, num_classes=7):
    """Raw per-scale NHWC head maps of a 64 px input (reg around 0, logits
    spread), in ``dtype`` (numpy float32 holding the rounded values)."""
    rng = np.random.RandomState(seed)
    outs = []
    for hw in (8, 4, 2):
        o = rng.randn(batch, hw, hw, 27 + num_classes).astype(np.float32) * 1.5
        outs.append(to_np(jnp.asarray(o).astype(DTYPES[dtype][0])))
    return outs


def both_heads(heads, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(h).astype(jdt) for h in heads],
            [torch.from_numpy(h).permute(0, 3, 1, 2).to(tdt) for h in heads])


def assert_detections_equal(got, want, rtol=0.0):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert str(got.rows.dtype) == f"torch.{want.rows.dtype}"
    np.testing.assert_allclose(got.rows.float().numpy(), to_np(want.rows),
                               rtol=rtol, atol=0)
    assert int(got.valid.sum()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parity", [False, True])
def test_postprocess_24p_heads_matches_jax(dtype, parity):
    """Raw head maps in the model's dtype: logits to fp32 for top-k, one row
    gather in the maps' dtype, decode in fp32: the same candidates, kept
    rows and mask as JAX's, rows within 1e-6 relative (fp32 exp of the two
    libraries, an ulp apart; tests/test_postprocess_fused.py's cases)."""
    jheads, theads = both_heads(rand_heads(1, dtype), dtype)
    kw = dict(num_classes=7, conf_thre=0.3, nms_thre=0.3, max_detections=32,
              nms_candidates=64, reference_parity=parity)
    assert_detections_equal(pp.postprocess_24p_heads(theads, **kw),
                            jpp.postprocess_24p_heads(jheads, **kw),
                            rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parity", [False, True])
def test_postprocess_24p_matches_jax(dtype, parity):
    """``inference_outputs`` decodes in the maps' dtype (JAX's within two
    ulps of that dtype: the exp and sigmoid of the two libraries); the
    decoded-input
    ``postprocess_24p`` on one decoded tensor computes in its dtype (bf16
    scores, threshold and rows; fp32 polygon points): rows and mask
    bit-equal to JAX's."""
    jheads, theads = both_heads(rand_heads(2, dtype), dtype)
    jdec = j_inference_outputs(jheads, reg_dim=26)
    tdec = inference_outputs(theads, reg_dim=26)
    assert tdec.dtype == DTYPES[dtype][1]
    two_ulps = 2.0 ** (-22 if dtype == "float32" else -6)
    np.testing.assert_allclose(tdec.float().numpy(), to_np(jdec),
                               rtol=two_ulps, atol=0)
    shared = torch.from_numpy(to_np(jdec)).to(DTYPES[dtype][1])
    kw = dict(num_classes=7, conf_thre=0.3, nms_thre=0.3, max_detections=32,
              nms_candidates=64, reference_parity=parity)
    assert_detections_equal(pp.postprocess_24p(shared, **kw),
                            jpp.postprocess_24p(jdec, **kw))


# ------------------------------------------------------------------ the loss

def test_training_outputs_and_loss_on_shared_bf16_heads_match_jax():
    """The same bf16 head maps into both packages: ``training_outputs``
    decodes in bf16 (within two bf16 ulps of JAX: the exp of the two
    libraries); then the loss, L1 on, on one decoded tensor: it upcasts
    ``decoded``, ``labels`` and ``origin_reg`` and gives the same SimOTA
    assignment and a total and every aux entry within 1e-5 relative."""
    heads = rand_heads(3, "bfloat16", batch=BATCH, num_classes=CLASSES)
    for h in heads:
        h[..., 2:26] = to_np(jnp.asarray(h[..., 2:26] * 0.3 + 0.7).astype(
            jnp.bfloat16))
    jheads, theads = both_heads(heads, "bfloat16")
    labels = make_labels(5)
    jdec, jreg, jgrids, jstrides = j_training_outputs(jheads, reg_dim=26)
    tdec, treg, tgrids, tstrides = training_outputs(theads, reg_dim=26)
    for g, w in ((tdec, jdec), (treg, jreg), (tgrids, jgrids),
                 (tstrides, jstrides)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().numpy(), to_np(w),
                                   rtol=2.0 ** -6, atol=0)
    tdec = torch.from_numpy(to_np(jdec)).to(torch.bfloat16)
    jcfg = JLossConfig(num_classes=CLASSES, use_l1=True)
    tcfg = Loss24PConfig(num_classes=CLASSES, use_l1=True)
    jtotal, jaux, _ = jax.jit(lambda d, r, lab, g, st: j_loss_24p(
        d, r, lab, g, st, JDWAState.init(), jcfg))(
            jdec, jreg, jnp.asarray(labels), jgrids, jstrides)
    lab = torch.from_numpy(labels)
    ttotal, taux, _ = loss_24p(tdec, treg, lab, tgrids, tstrides,
                               DWAState.init(), tcfg)
    assert ttotal.dtype == torch.float32
    np.testing.assert_allclose(ttotal.item(), float(jtotal), rtol=1e-5)
    for name in jaux._fields:
        np.testing.assert_allclose(
            getattr(taux, name).detach().numpy(),
            np.asarray(getattr(jaux, name)), rtol=1e-5, atol=1e-6,
            err_msg=name)
    dec32 = tdec.float()
    got = simota_assign_24p(
        lab[..., 1:], lab[..., 0], lab.sum(dim=2) > 0, dec32[..., :26],
        dec32[..., 26], dec32[..., 27:], tgrids, tstrides, tcfg)
    jd = jdec.astype(jnp.float32)
    want = jax.jit(jax.vmap(lambda lxy, gc, gv, pr, ob, cl: j_assign(
        lxy, gc, gv, pr, ob, cl, jgrids, jstrides, jcfg)))(
            jnp.asarray(labels[..., 1:]), jnp.asarray(labels[..., 0]),
            jnp.asarray(labels.sum(axis=2) > 0), jd[..., :26], jd[..., 26],
            jd[..., 27:])
    np.testing.assert_array_equal(got.fg_mask.numpy(),
                                  np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.matched_gt.numpy(),
                                  np.asarray(want.matched_gt))
    assert int(got.fg_mask.sum()) >= 6


def test_whole_bf16_step_against_jax(common):
    """One training step from one state on one 128 px batch (train-mode
    forward, decode, loss, backward): JAX's in bf16, the port's in bf16 and
    in fp32 (which test_torch_train_step.py holds to JAX's fp32 step).  At
    this size a bf16 step's gradients are dominated by bf16 rounding
    (train-mode BatchNorm over 32 to 2048 values a channel cancels most of
    each gradient, and SimOTA's assignment is discrete): JAX's bf16
    gradients have a median cosine of 0.37 with the fp32 ones here, the
    port's 0.49.  So the port's bf16 step is held to JAX's by how far each
    lies from the fp32 step: the port's bf16 loss within 5e-2 relative of
    JAX's bf16 loss and of the fp32 loss (measured 2.5e-2 and 1.6e-2 here;
    at most 2.7e-2 over the label seeds tried at 64 and 128 px), and the
    median over the parameters of the gradients' cosine with the fp32 step
    no lower than JAX bf16's less 0.1.  Every gradient reaches its fp32
    parameter, finite."""
    jmodels, variables, sd, _ = common
    x = np.random.RandomState(8).uniform(0, 255, (BATCH, 128, 128, 3)
                                         ).astype(np.float32)
    labels = make_labels(7, size=128)
    cfg = Loss24PConfig(num_classes=CLASSES)

    def j_total(params):
        (heads, _), _ = jmodels["bfloat16"].apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), True, mutable=["batch_stats"])
        dec, reg, grids, strides = j_training_outputs(heads, reg_dim=26)
        return j_loss_24p(dec, reg, jnp.asarray(labels), grids, strides,
                          JDWAState.init(), JLossConfig(num_classes=CLASSES))[0]

    loss, grads = jax.jit(jax.value_and_grad(j_total))(variables["params"])
    jax16 = (float(loss), state_dict_from_jax({"params": (
        jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads))}))
    port = {}
    for dt in (torch.float32, torch.bfloat16):
        model = port_model(sd, dt).train()
        heads, _ = model(nchw(x))
        dec, reg, grids, strides = training_outputs(heads, reg_dim=26)
        total, _, _ = loss_24p(dec, reg, torch.from_numpy(labels), grids,
                               strides, DWAState.init(), cfg)
        total.backward()
        port[dt] = (total.item(), {n: p.grad for n, p in
                                   model.named_parameters()})
        for name, p in model.named_parameters():
            assert p.dtype == p.grad.dtype == torch.float32, name
            assert torch.isfinite(p.grad).all(), name
    (l32, g32), (l16, g16) = port[torch.float32], port[torch.bfloat16]
    for want in (jax16[0], l32):
        assert abs(l16 - want) <= 5e-2 * abs(want), (l16, want)

    def cos(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return (a @ b / (a.norm() * b.norm())).item()

    ours, jaxs = [], []
    for name, ref in g32.items():
        if ref.abs().max() > 0:  # a level without foreground: zero
            ours.append(cos(g16[name], ref))
            jaxs.append(cos(jax16[1][name], ref))
    assert len(ours) >= 150
    assert np.median(ours) >= np.median(jaxs) - 0.1, (np.median(ours),
                                                      np.median(jaxs))


# ------------------------------------------------------------------- remat

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_the_plain_step(common, dtype):
    """One training step (forward, loss, backward, nesterov SGD, EMA) with
    ``remat`` against the same step without, from one state on one batch
    (JAX: tests/test_train_components.py::test_remat_gradients_match_baseline):
    loss, gradients, updated parameters, EMA, BN running statistics within
    1e-6 (measured: the same bits), ``num_batches_tracked`` 1 in every BN:
    the recompute runs the backbone + neck a second time (the stem twice)
    without a second update."""
    _, _, sd, x = common
    labels = torch.from_numpy(make_labels(9))
    exp = Exp24P()
    out = {}
    for remat in (False, True):
        model = port_model(sd, DTYPES[dtype][1], remat=remat)
        stem_calls = []
        model.backbone.backbone.stem.register_forward_hook(
            lambda *_: stem_calls.append(1))
        state = create_train_state(model, exp.get_optimizer(model, BATCH,
                                                            lr=0.01),
                                   use_ema=True, with_dwa=True)
        step = make_train_step_24p(Loss24PConfig(num_classes=CLASSES),
                                   ema_decay=0.9998)
        state, metrics = step(state, torch.from_numpy(x), labels)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        out[remat] = (metrics["total_loss"].item(), grads,
                      model.state_dict(), state.ema_params, len(stem_calls))
    (l0, g0, s0, e0, c0), (l1, g1, s1, e1, c1) = out[False], out[True]
    assert (c0, c1) == (1, 2)
    assert abs(l0 - l1) <= 1e-6 * abs(l0)

    def close(a, b, what):
        bound = 1e-6 * max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= bound, what

    for name in g0:
        close(g1[name], g0[name], f"grad {name}")
        close(e1[name], e0[name], f"ema {name}")
    for name, v in s0.items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == int(s1[name]) == 1, name
        else:
            close(s1[name], v, name)


def test_remat_acts_only_in_training_under_autograd(common):
    """Eval, or training without autograd, runs the backbone once and the
    same as without ``remat``."""
    _, _, sd, x = common
    plain, rem = (port_model(sd, torch.float32, remat=r) for r in (0, 1))
    with torch.no_grad():
        for mode in ("eval", "train"):
            for m in (plain, rem):
                getattr(m, mode)()
            a, b = heads_np(plain(nchw(x))[0]), heads_np(rem(nchw(x))[0])
            for g, w in zip(b, a):
                np.testing.assert_array_equal(g, w)


# --------------------------------------------------------- kernel variants

# the 8 early convs of 24p-s at 640 px: (k, stride, padding, H, W, C, Co)
MAIN_PATH = [
    (6, 2, 2, 640, 640, 3, 32),
    (3, 2, 1, 320, 320, 32, 64),
    (1, 1, 0, 160, 160, 64, 32),
    (1, 1, 0, 160, 160, 64, 32),
    (1, 1, 0, 160, 160, 32, 32),
    (3, 1, 1, 160, 160, 32, 32),
    (1, 1, 0, 160, 160, 64, 64),
    (3, 2, 1, 160, 160, 64, 128),
]


@pytest.mark.parametrize("batch", [8, 32])
def test_main_path_shapes_take_tensor_core_variants_in_bf16(batch):
    """The variant each of the 8 main-path convs takes on the card in bf16
    (decided on the host from shape and type): the forward on
    ``wgmma_rows`` (stem) / ``wgmma_taps``, the weight gradient on
    ``wgmma``, the data gradient on ``wgmma_classes`` (stride 2) /
    ``flipped:wgmma_taps`` (stride 1); never ``direct`` or ``cuda_cores``.
    The same as fp32."""
    for i, (k, s, p, h, w, c, co) in enumerate(MAIN_PATH):
        x_shape = (batch, h, w, c)
        ho, wo = pc.out_hw(h, w, k, s, p)
        for dt in (torch.bfloat16, torch.float32):
            assert pc.kernel_variant(x_shape, (k, k, c, co), s, p, dt) == (
                "wgmma_rows" if i == 0 else "wgmma_taps")
            assert pc.wgrad_variant(x_shape, co, k, s, dt) == "wgmma"
            if i:  # the stem's input is the image: no data gradient
                assert pc.dgrad_variant((batch, ho, wo, co), (k, k, c, co),
                                        s, p, dt) == (
                    "wgmma_classes" if s == 2 else "flipped:wgmma_taps")
