"""int8 post-training quantization and ``fuse_conv_bn`` of the port
(``eop_tpu_torch/ops/quant.py``, ``utils/model_utils.py``) against
``eop_tpu``'s (``eop_tpu/ops/quant.py``, ``eop_tpu/utils/model_utils.py``),
on the CPU, for both families at a tiny size (depth 0.33, width 0.125, 3
classes, 64 px, ``min_channels`` 16, as ``tests/test_quant.py`` gates).

The JAX exps run the fine layout (``packed_early False``): ``eop_tpu``'s
packed layout quantizes the early stages at their packed widths, and the
port has no packed layout (ROADMAP.md queue 1 item 9).  Weights go across
with ``utils/weights.py::state_dict_from_jax``; scale keys map with its
``unmap_key`` (``a/b_0/conv`` -> ``a.b.0.conv``).
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn
from jax import lax

from eop_tpu.exp import Exp as JaxExp
from eop_tpu.exp.yolox_24p_base import Exp24P as JaxExp24P
from eop_tpu.ops import quant as jquant
from eop_tpu.utils.model_utils import fuse_conv_bn as jax_fuse_conv_bn
from eop_tpu.utils.torch_import import convert_state_dict
from eop_tpu_torch.exp import Exp, Exp24P
from eop_tpu_torch.ops import quant
from eop_tpu_torch.ops.blocks import BaseConv
from eop_tpu_torch.tools import eval as eval_cli
from eop_tpu_torch.utils.model_utils import fuse_conv_bn
from eop_tpu_torch.utils.synth import write_24p_dataset
from eop_tpu_torch.utils.weights import state_dict_from_jax, unmap_key

MIN_CH = 16
SIZE = 64


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(exp, depthwise=False):
    exp.depth, exp.width, exp.num_classes = 0.33, 0.125, 3
    exp.input_size = exp.test_size = (SIZE, SIZE)
    exp.test_conf = 5e-5
    exp.depthwise = depthwise
    return exp


def images(seed, n=2, scale=255):
    return (np.random.RandomState(seed).rand(n, SIZE, SIZE, 3)
            * scale).astype(np.float32)


FAMILIES = {"bbox": (JaxExp, Exp), "24p": (JaxExp24P, Exp24P),
            "bbox_depthwise": (JaxExp, Exp)}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    """(family, jax exp, jax model, variables, port exp, port model): the
    port's seeded weights through eop_tpu's importer (no JAX init)."""
    jfam, fam = FAMILIES[request.param]
    dw = request.param.endswith("depthwise")
    exp = tiny(fam(), dw)
    model = exp.get_model("cpu")
    jexp = tiny(jfam(), dw)
    jexp.packed_early = False
    jmodel = jexp.get_model()
    variables = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    # the round trip is the identity: the two hold the same weights
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return request.param, jexp, jmodel, variables, exp, model


def port_key(jax_key: str) -> str:
    return unmap_key(jax_key.replace("/", "."))


@pytest.fixture(scope="module")
def calibrated(pair):
    """Both packages calibrated on the same two batches."""
    _, jexp, jmodel, variables, exp, model = pair
    batches = [images(1), images(2, scale=400)]
    jvars, jscales = jexp.quantize_for_inference(jmodel, variables, batches,
                                                 MIN_CH)
    deploy, scales = exp.quantize_for_inference(model, batches, MIN_CH)
    return batches, jvars, jscales, deploy, scales


def test_eligible_set_and_scales_match_eop_tpu(pair, calibrated):
    family = pair[0]
    batches, _, jscales, deploy, scales = calibrated
    want = {port_key(k): v for k, v in jscales.items()}
    assert set(scales) == set(want)
    for k, v in scales.items():
        assert v == pytest.approx(want[k], rel=1e-5), k
    # observed at max(1, 16 // 4): the head's reg/obj preds (3-channel
    # outputs) and the folded Focus stem never; grouped convs never
    assert not any("stem.conv.conv" in k for k in scales)
    grouped = {f"{n}.conv" for n, m in deploy.named_modules()
               if isinstance(m, BaseConv) and m.conv.groups > 1}
    assert (len(grouped) > 0) == (family == "bbox_depthwise")
    assert not grouped & set(scales)
    # the quantized set at the gate
    qmodel = quant.quantize_model(deploy, scales, MIN_CH)
    swapped = {f"{n}.conv" if isinstance(m, quant.QuantBaseConv) else n
               for n, m in qmodel.named_modules()
               if isinstance(m, (quant.QuantBaseConv, quant.QuantConv2d))
               and not n.endswith(".conv")}
    sites = quant.conv_sites(deploy)
    assert swapped == {k for k in scales
                       if quant.eligible(sites[k], MIN_CH)}
    assert len(swapped) < len(scales)


def test_calibration_takes_the_max_over_batches(pair, calibrated):
    *_, exp, model = pair
    batches, _, _, _, scales = calibrated
    per = [exp.quantize_for_inference(model, [b], MIN_CH)[1] for b in batches]
    # each run folds a fresh copy and runs the CPU's convs again: equal to
    # fp32 rounding
    for k, v in scales.items():
        assert v == pytest.approx(max(p.get(k, 0.0) for p in per),
                                  rel=1e-6), k
    # the second batch (a wider range) raises some scales above the first's
    assert any(per[1][k] > per[0][k] for k in per[0])


def test_fuse_conv_bn_matches_eop_tpu(pair):
    *_, variables, exp, model = pair
    fused = fuse_conv_bn(exp.get_model("cpu"))
    fused.load_state_dict(model.state_dict())
    fuse_conv_bn(fused)
    jp, js = jax_fuse_conv_bn(variables["params"], variables["batch_stats"])
    want = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jp, "batch_stats": js}))
    got = fused.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # the fused model computes what the unfused one does
    x = torch.from_numpy(images(3)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        a, _ = model(x)
        b, _ = fused(x)
    for u, v in zip(a, b):
        np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("backbone", ["vgg", "resnet", "densenet"])
def test_fuse_conv_bn_study_backbones(backbone):
    """The port folds each BaseConv (VGG's convs, DenseNet's stem and
    transitions; ResNet has none) as eop_tpu folds those, and leaves every
    other BatchNorm alone, so the model computes what it did.  eop_tpu's
    walk over the whole tree does not: it resets every BatchNorm's
    statistics, folded or not (ResNet's), and folds DenseNet's
    pre-activation BN (BN, ReLU, then the conv, other channel counts) into
    the conv after it, which raises."""
    exp = tiny(Exp())
    exp.width = 0.25
    model = exp.get_model("cpu", backbone_type=backbone)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    fused = exp.get_model("cpu", backbone_type=backbone)
    fused.load_state_dict(model.state_dict())
    fuse_conv_bn(fused)
    got = fused.state_dict()
    base = tuple(f"{n}." for n, m in model.named_modules()
                 if isinstance(m, BaseConv))
    # eop_tpu's fold of the BaseConvs alone
    part = convert_state_dict({k: v for k, v in sd.items()
                               if k.startswith(base)})
    jp, js = jax_fuse_conv_bn(part["params"], part["batch_stats"])
    want = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jp, "batch_stats": js}))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k, v in sd.items():
        if not k.startswith(base):
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    x = torch.from_numpy(images(4, n=1)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        a, _ = model(x)
        b, _ = fused(x)
    for u, v in zip(a, b):
        np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=1e-4,
                                   atol=1e-4)
    whole = convert_state_dict(sd)
    if backbone == "densenet":
        with pytest.raises(TypeError, match="incompatible shapes"):
            jax_fuse_conv_bn(whole["params"], whole["batch_stats"])
    elif backbone == "resnet":
        _, stats = jax_fuse_conv_bn(whole["params"], whole["batch_stats"])
        var = state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, {"batch_stats": stats}))
        key = "backbone.backbone.bn1.running_var"
        assert not np.allclose(var[key].numpy(), sd[key])


def test_quantize_kernel_bit_equal():
    w = np.random.RandomState(5).randn(3, 3, 24, 40).astype(np.float32)
    w[..., 7] = 0.0                                 # an all-zero channel
    w[0, 0, 0, 3] = 1e-30                           # a subnormal-range one
    jq, js = jquant._quantize_kernel(jnp.asarray(w))
    q, s = quant.quantize_kernel(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(q.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# (k, stride, C, Co, B, H, W): the second pads K (9 * 3 = 27) and N (5)
# and the fourth M (1 * 2 * 2 = 4 rows) up to _int_mm's CUDA shapes
ACC_CASES = [(3, 1, 16, 24, 2, 8, 8), (3, 2, 3, 5, 1, 6, 10),
             (1, 1, 32, 16, 2, 6, 6), (1, 1, 8, 8, 1, 2, 2),
             (3, 2, 32, 64, 1, 8, 8), (1, 2, 16, 8, 1, 4, 4)]


@pytest.mark.parametrize("case", ACC_CASES)
def test_int32_accumulator_bit_equal_to_lax(case):
    k, s, c, co, b, h, w = case
    rng = np.random.RandomState(sum(case))
    q_x = rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)
    q_w = rng.randint(-127, 128, (k, k, c, co)).astype(np.int8)
    p = (k - 1) // 2
    want = lax.conv_general_dilated(
        jnp.asarray(q_x), jnp.asarray(q_w), (s, s), [(p, p), (p, p)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    # [Co, ky, kx, C] rows, as QuantConv2d lays them out, transposed
    w2 = torch.from_numpy(q_w).permute(3, 0, 1, 2).reshape(co, -1).t()
    before = quant.int8_conv.calls
    got = quant.int8_conv(torch.from_numpy(q_x), w2, k, s, p)
    assert quant.int8_conv.calls == before + 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int_mm_padding():
    rng = np.random.RandomState(6)
    for m, kk, n in ((1, 1, 1), (16, 8, 8), (17, 27, 5), (40, 64, 13)):
        a = torch.from_numpy(rng.randint(-127, 128, (m, kk)).astype(np.int8))
        bt = torch.from_numpy(rng.randint(-127, 128, (n, kk)).astype(np.int8))
        got = quant.int_mm_padded(a, bt.t())
        want = a.long() @ bt.t().long()
        assert got.dtype == torch.int32 and got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_conv_without_a_scale_falls_through(pair, calibrated):
    *_, exp, model = pair
    _, _, _, deploy, scales = calibrated
    x = torch.from_numpy(images(7)).permute(0, 3, 1, 2)
    # a scale of 0 (an all-zero input) falls through too
    models = [quant.quantize_model(deploy, q, MIN_CH)
              for q in ({}, {k: 0.0 for k in scales})]
    sites = quant.conv_sites(deploy)
    few = [k for k in scales if quant.eligible(sites[k], MIN_CH)][:3]
    one = quant.quantize_model(deploy, {k: scales[k] for k in few}, MIN_CH)
    with torch.inference_mode():
        want, _ = deploy(x)
        none, _ = models[0](x)
        zero, _ = models[1](x)
    for u, v, z in zip(want, none, zero):
        np.testing.assert_array_equal(v.numpy(), u.numpy())
        np.testing.assert_array_equal(z.numpy(), u.numpy())
    n_q = sum(isinstance(m, quant.QuantConv2d) for m in one.modules())
    assert n_q == 3


def _capture(scales):
    """A flax interceptor that sows each quantized conv's input and output
    (installed outside ``quantized``, so it runs first)."""

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not (context.method_name == "__call__"
                and isinstance(mod, nn.Conv)
                and jquant._eligible(mod, args[0], MIN_CH)
                and jquant._module_path(mod) in scales):
            return next_fun(*args, **kwargs)
        y = next_fun(*args, **kwargs)
        mod.sow("q_io", "x", args[0])
        mod.sow("q_io", "y", y)
        return y

    return interceptor


def _port_int8(qmodel, imgs):
    """Head maps and each QuantConv2d's int8 input codes, by scale key."""
    codes = {}

    def hook_for(name, conv):
        def hook(_m, args):
            x = args[0].contiguous(
                memory_format=torch.channels_last).permute(0, 2, 3, 1)
            codes[name] = quant.quantize_act(x, conv.s_x).numpy()
        return hook

    handles = [m.register_forward_pre_hook(hook_for(n, m))
               for n, m in qmodel.named_modules()
               if isinstance(m, quant.QuantConv2d)]
    with torch.inference_mode():
        heads, _ = qmodel(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    for h in handles:
        h.remove()
    return [h.numpy() for h in heads], codes


def _head_rel(heads, jheads):
    return max(float(np.abs(h - np.asarray(j).transpose(0, 3, 1, 2)).max()
                     / np.abs(np.asarray(j)).max())
               for h, j in zip(heads, jheads))


def test_int8_forward_matches_eop_tpu(pair, calibrated):
    """The int8 forward against eop_tpu's (``quantized(scales)`` around
    ``model.apply``), each on its own folded weights.

    Conv by conv, on eop_tpu's input and scale, the port's int8 conv gives
    eop_tpu's output to 1e-6 of its largest magnitude: the same codes and
    int32 sums (bit-equal in ``test_int32_accumulator_bit_equal_to_lax``),
    dequantized by ``s_w`` from folded weights that differ from eop_tpu's
    in the last bit where the two folds round apart.  The
    whole forward's head maps, each package on its own calibration, agree
    to 1e-1 of each map's largest magnitude: the two runs' activations
    differ by fp32 summation order (1e-7 relative), which moves an
    activation code by one wherever a value sits that close to a rounding
    boundary, and each move shifts the next convs' inputs by a code step
    (1/127 of a range), which moves more codes.  The share of int8
    activation codes that differ from eop_tpu's is printed."""
    family, jexp, jmodel, *_ = pair
    _, jvars, jscales, deploy, scales = calibrated
    imgs = images(8)

    @jax.jit
    def jfwd(im):
        with nn.intercept_methods(_capture(jscales)):
            with jquant.quantized(jscales, MIN_CH):
                (heads, _), seen = jmodel.apply(jvars, im, False,
                                                mutable=["q_io"])
        return heads, seen

    jheads, seen = jfwd(jnp.asarray(imgs))
    io = {}

    def walk(node, path):
        if "x" in node:
            io[port_key("/".join(path))] = (np.asarray(node["x"][0]),
                                            np.asarray(node["y"][0]))
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))

    walk(jax.tree_util.tree_map(np.asarray, seen["q_io"]), ())
    jscale = {port_key(k): v for k, v in jscales.items()}
    qmodel = quant.quantize_model(deploy, jscale, MIN_CH)
    convs = {n: m for n, m in qmodel.named_modules()
             if isinstance(m, quant.QuantConv2d)}
    assert set(convs) == set(io) and convs
    jcodes = {}
    for name, conv in convs.items():
        x, y = io[name]
        with torch.inference_mode():
            got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        err = np.abs(got.permute(0, 2, 3, 1).numpy() - y).max()
        assert err <= 1e-6 * np.abs(y).max(), (name, err)
        jcodes[name] = np.clip(np.round(x / np.float32(jscale[name])),
                               -127, 127)
    heads, codes = _port_int8(quant.quantize_model(deploy, scales, MIN_CH),
                              imgs)
    differ = sum(int((codes[k] != jcodes[k]).sum()) for k in codes)
    total = sum(c.size for c in codes.values())
    rel = _head_rel(heads, jheads)
    print(f"{family}: {differ} of {total} int8 activation codes differ from "
          f"eop_tpu's ({differ / total:.2e}); head maps within {rel:.2e} of "
          "their largest magnitude")
    assert rel < 1e-1


def test_quant_infer_fn_structure(pair):
    *_, exp, model = pair
    imgs = images(9).astype(np.uint8)
    infer, scales = exp.get_quant_infer_fn(model, [imgs], MIN_CH)
    assert scales
    det = infer(imgs)
    fp = exp.get_infer_fn(model, "cpu")(imgs)
    assert det.rows.shape == fp.rows.shape and det.rows.dtype == fp.rows.dtype
    assert det.valid.shape == fp.valid.shape and det.valid.dtype == torch.bool
    before = quant.int8_conv.calls
    infer(imgs)
    assert quant.int8_conv.calls > before


def test_int8_of_a_bf16_model_or_a_resnet_raises():
    exp = tiny(Exp24P())
    exp.compute_dtype = "bfloat16"
    with pytest.raises(NotImplementedError, match="bfloat16"):
        exp.quantize_for_inference(exp.get_model("cpu"), [images(0)], MIN_CH)
    exp = tiny(Exp())
    with pytest.raises(NotImplementedError, match="F.conv2d"):
        exp.quantize_for_inference(
            exp.get_model("cpu", backbone_type="resnet"), [images(0)],
            MIN_CH)


def test_eval_int8_command_line(tmp_path, capsys):
    img_dir, lab_dir = write_24p_dataset(str(tmp_path / "d"), 4, (90, 160),
                                         seed=4)
    eval_cli.main(["-f", "load_eval/yolox_24p_eval.py", "-b", "2",
                   "--data-dir", img_dir, "--label-dir", lab_dir,
                   "--device", "cpu", "--int8", "--quant-min-channels",
                   str(MIN_CH), "--conf", "0.001", "depth", "0.33", "width",
                   "0.125", "num_classes", "3", "test_size", "(64, 64)",
                   "data_num_workers", "0"])
    out = capsys.readouterr().out
    m = re.search(r"^int8 PTQ: (\d+) convs quantized \(min_channels=16\)$",
                  out, re.MULTILINE)
    assert m and int(m.group(1)) > 0
    assert re.search(r"^AP50:95 = [0-9.]+  AP50 = [0-9.]+$", out,
                     re.MULTILINE)
