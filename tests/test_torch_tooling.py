"""The port's small tools against ``eop_tpu`` on the CPU:

* the model summary: ``get_model_info``'s parameter count is
  ``eop_tpu``'s exactly, and its multiply-accumulates sit at most 3 %
  under ``eop_tpu``'s (XLA's cost analysis of the forward, halved) for a
  24p and a bbox exp at 64 and 128 px; the gap is the elementwise work XLA
  counts beside the convs, 6 to 10 flops an output element of a
  ``BaseConv`` (its BatchNorm and SiLU, 8 in XLA's count, with the adds,
  pools and decode; measured 7.5-8.2).  Every
  conv counts as the conv it computes: ``phase_conv``'s operator under
  ``FlopCounterMode`` on meta and CPU tensors as ``F.conv2d``, and the
  summary the same string whichever route the early convs take;
* the bbox ``Trainer`` logs ``Model summary: `` once, ``Trainer24P`` not
  at all (as ``eop_tpu``'s);
* ``make_synth_datasets`` (``coco`` and ``24p``) against
  ``tools/make_synth_datasets.py`` loaded by path: the annotation JSON and
  the label files byte-equal, the drawn images bit-equal before encoding,
  and the JPEG files decoded within 12 levels of OpenCV's (mean under one
  level: two baseline encoders at quality 95);
* ``logger.catch``: the traceback logged, the exception raised again, the
  exit code a command line's own.
"""

import importlib.util
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eop_tpu_torch.exp import get_exp
from eop_tpu_torch.ops.blocks import BaseConv
from eop_tpu_torch.ops.phase_conv import phase_conv
from eop_tpu_torch.tools import make_synth_datasets
from eop_tpu_torch.utils.logger import catch, logger
from eop_tpu_torch.utils.model_utils import (
    conv_macs,
    count_macs,
    count_params,
    get_model_info,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["depth", "0.33", "width", "0.25"]
EXPS = {"24p": ("load_eval/yolox_24p_eval.py", None), "bbox": (None,
                                                               "yolox-s")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(kind, size, jax_side=False):
    f, name = EXPS[kind]
    if jax_side:
        from eop_tpu.exp import get_exp as get_jax_exp

        exp = get_jax_exp(f and os.path.join(ROOT, f), name)
    else:
        exp = get_exp(f and os.path.join(ROOT, f), name)
    exp.merge([*SMALL, "test_size", f"({size},{size})"])
    return exp


def _xla_summary(kind, size):
    """eop_tpu's summary string and XLA's flops of the forward at batch 1
    (variables traced by shape, not made)."""
    import jax
    import jax.numpy as jnp

    from eop_tpu.utils.model_utils import get_model_info as jax_info

    model = _exp(kind, size, jax_side=True).get_model()
    x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    variables = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(x.shape), False))
    cost = jax.jit(lambda v, i: model.apply(v, i, False)).lower(
        variables, x).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return jax_info(model, variables, (size, size)), float(cost["flops"])


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("kind", ["24p", "bbox"])
def test_model_summary_matches_eop_tpu(kind, size):
    """Params equal; MACs at most 3 % under XLA's, the gap 6-10 flops an
    output element of a BaseConv (the BatchNorm and activation XLA counts
    beside the convs)."""
    want, xla_flops = _xla_summary(kind, size)
    model = _exp(kind, size).get_model("cpu")
    got = get_model_info(model, (size, size))
    assert got.split(",")[0] == want.split(",")[0]
    macs = count_macs(model, (size, size))
    gap = xla_flops / 2 - macs
    assert 0 <= gap <= 0.03 * xla_flops / 2, (macs, xla_flops / 2)
    elements = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: elements.append(o.numel()))
        for m in model.modules() if isinstance(m, BaseConv)]
    with torch.no_grad():
        model(torch.zeros(1, 3, size, size))
    for h in hooks:
        h.remove()
    assert 6 <= 2 * gap / sum(elements) <= 10, 2 * gap / sum(elements)
    # the string of eop_tpu's count to two decimals, when its rounding
    # falls on the same side
    if round(macs / 1e9, 2) == round(xla_flops / 2e9, 2):
        assert got == want


def test_summary_counts_each_conv_as_the_conv_it_computes():
    """The summary is one string whichever route the convs take: the
    phase_conv model (its stride-2 convs computed on the CPU as 2x2 taps
    over space-to-depth phases) counts as the same model on F.conv2d, and
    the count runs on the meta device, touching no launch counter."""
    exp = _exp("24p", 128)
    model = exp.get_model("cpu")
    plain = exp.get_model("cpu")
    phase = [m for m in model.modules()
             if isinstance(m, BaseConv) and m.phase_conv]
    assert len(phase) == 8
    for m in plain.modules():
        if isinstance(m, BaseConv):
            m.phase_conv = False
    before = phase_conv.launches
    assert count_macs(model, (128, 128)) == count_macs(plain, (128, 128))
    assert get_model_info(model, (128, 128)) == get_model_info(
        plain, (128, 128))
    assert phase_conv.launches == before
    assert count_params(model) == count_params(plain)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0),
                                          (6, 2, 2)])
def test_phase_conv_flop_formula_is_the_conv(k, stride, pad):
    """The operator's registered formula gives F.conv2d's count of the
    same conv, on a meta tensor (through its fake implementation) and on
    a CPU tensor under autograd's no-grad (the plain version runs, the
    formula counts); conv_macs counts only the taps inside the image."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.randn(2, 16, 12, 8)
    w = torch.randn(k, k, 8, 16)
    with FlopCounterMode(display=False) as plain:
        want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                        stride, pad)
    for dev in ("meta", "cpu"):
        with torch.no_grad(), FlopCounterMode(display=False) as counted:
            got = torch.ops.eop_tpu_torch.phase_conv(
                x.to(dev), w.to(dev), stride, pad, None, None, None, False)
        assert counted.get_total_flops() == plain.get_total_flops()
        assert got.shape == want.permute(0, 2, 3, 1).shape
    with torch.no_grad(), FlopCounterMode(display=False) as counted:
        got = phase_conv(x, w, stride, pad)
    assert counted.get_total_flops() == plain.get_total_flops()
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), atol=1e-4,
                               rtol=1e-4)
    # the taps on the padding: none at k 1, the borders' at k 3 and 6
    full = want.numel() * 8 * k * k
    inside = conv_macs(2, (16, 12), 8, 16, k, stride, pad)
    assert (inside == full) == (pad == 0)
    assert 0 < inside <= full


def test_bbox_trainer_logs_the_summary_once(tmp_path):
    """tools.train logs "Model summary: " + get_model_info of the exp's
    model at test_size, once; tools.train_24p logs none."""
    from eop_tpu_torch.tools import train as train_cli
    from eop_tpu_torch.tools import train_24p as train_24p_cli
    from eop_tpu_torch.utils.synth import write_24p_dataset, \
        write_coco_dataset

    tiny = ["depth", "0.33", "width", "0.125", "num_classes", "3",
            "input_size", "(64,64)", "test_size", "(64,64)",
            "data_num_workers", "0", "max_epoch", "1"]
    coco = write_coco_dataset(str(tmp_path / "coco"), 2, 2, (64, 64),
                              num_classes=3, seed=2)
    train_cli.main(["-n", "yolox-s", "-b", "2", "--data-dir", coco,
                    "--device", "cpu", *tiny, "no_aug_epochs", "0",
                    "multiscale_range", "0", "output_dir",
                    str(tmp_path / "bbox")])
    exp = get_exp(exp_name="yolox-s")
    exp.merge(tiny)
    want = "Model summary: " + get_model_info(exp.get_model("cpu"), (64, 64))
    with open(tmp_path / "bbox" / "yolox_s" / "train_log.txt") as f:
        lines = [ln for ln in f if "Model summary: " in ln]
    assert len(lines) == 1 and lines[0].rstrip().endswith(want), lines
    img_dir, lab_dir = write_24p_dataset(str(tmp_path / "d24p"), 2, (64, 64),
                                         seed=4)
    train_24p_cli.main(["-b", "2", "--data-dir", img_dir, "--label-dir",
                        lab_dir, "--device", "cpu", *tiny, "output_dir",
                        str(tmp_path / "p24")])
    logs = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "p24")
            for f in fs if f == "train_log.txt"]
    assert logs and not any("Model summary" in open(p).read() for p in logs)


# ---------------------------------------------------------------------------
# make_synth_datasets
# ---------------------------------------------------------------------------

def _jax_synth_module():
    spec = importlib.util.spec_from_file_location(
        "_jax_make_synth", os.path.join(ROOT, "tools",
                                        "make_synth_datasets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# coco draws boxes of 30 to 0.35 x size pixels: 86 px at least
@pytest.mark.parametrize("flavor,size", [("coco", 96), ("coco", 128),
                                         ("24p", 64), ("24p", 128)])
def test_make_synth_datasets_matches_eop_tpu(flavor, size, tmp_path,
                                             monkeypatch):
    cv2 = pytest.importorskip("cv2")
    from eop_tpu_torch.data.image_io import imread

    ref = _jax_synth_module()
    drawn = {"ref": {}, "port": {}}
    imwrite = cv2.imwrite

    def ref_write(path, img):
        drawn["ref"][os.path.relpath(path, tmp_path / "ref")] = img.copy()
        return imwrite(path, img)

    write_jpeg = make_synth_datasets.write_jpeg

    def port_write(path, img):
        drawn["port"][os.path.relpath(path, tmp_path / "port")] = img.copy()
        return write_jpeg(path, img)

    monkeypatch.setattr(ref.cv2, "imwrite", ref_write)
    monkeypatch.setattr(make_synth_datasets, "write_jpeg", port_write)
    args = ["--size", str(size), "--n", "4", "--n-val", "2", "--seed", "3"]
    for who in ("ref", "port"):
        argv = [flavor, "--out", str(tmp_path / who), *args]
        if who == "ref":
            monkeypatch.setattr(sys, "argv", ["make_synth_datasets.py",
                                              *argv])
            ref.main()
        else:
            make_synth_datasets.main(argv)
    files = _files(tmp_path / "ref")
    assert files == _files(tmp_path / "port")
    assert drawn["ref"].keys() == drawn["port"].keys()
    assert len(drawn["ref"]) == (6 if flavor == "coco" else 4)
    for name in files:
        a = (tmp_path / "ref" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        if not name.endswith(".jpg"):  # annotation json, label txt
            assert a == b, name
            continue
        np.testing.assert_array_equal(drawn["port"][name],
                                      drawn["ref"][name], err_msg=name)
        got = imread(str(tmp_path / "port" / name)).astype(int)
        want = cv2.imread(str(tmp_path / "ref" / name)).astype(int)
        diff = np.abs(got - want)
        assert diff.max() <= 12 and diff.mean() < 1.0, (name, diff.max(),
                                                         diff.mean())


def test_make_synth_datasets_draws_without_opencv(tmp_path, monkeypatch):
    """With cv2 unimportable the generator still writes both flavours."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    make_synth_datasets.main(["24p", "--out", str(tmp_path / "a"), "--size",
                              "64", "--n", "2"])
    make_synth_datasets.main(["coco", "--out", str(tmp_path / "b"),
                              "--size", "96", "--n", "2", "--n-val", "1"])
    assert len(os.listdir(tmp_path / "a" / "labels")) == 2
    assert len(os.listdir(tmp_path / "b" / "val2017")) == 1


# ---------------------------------------------------------------------------
# catch
# ---------------------------------------------------------------------------

def test_catch_logs_the_traceback_and_raises_again(caplog):
    @catch
    def main():
        raise ValueError("bad value")

    @catch
    def leaves():
        raise SystemExit(3)

    logger.propagate, prev = True, logger.propagate
    try:
        with caplog.at_level(logging.ERROR, logger=logger.name):
            with pytest.raises(ValueError, match="bad value"):
                main()
            with pytest.raises(SystemExit):
                leaves()
    finally:
        logger.propagate = prev
    errors = [r for r in caplog.records if r.levelno == logging.ERROR]
    assert len(errors) == 1 and "uncaught exception in main" in \
        errors[0].getMessage()
    assert errors[0].exc_info[0] is ValueError
    assert main.__name__ == "main"


@pytest.mark.parametrize("tool", ["train_24p", "eval"])
def test_command_line_exit_code_under_catch(tool, tmp_path):
    """An exception out of a main exits 1 with Python's traceback after
    the logged one; a SystemExit keeps its code and message."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = [sys.executable, "-m", f"eop_tpu_torch.tools.{tool}"]
    r = subprocess.run(run + ["-f", str(tmp_path / "missing.py"), "--device",
                              "cpu", "--data-dir", "x", "--label-dir", "y"],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=120)
    assert r.returncode == 1, r.stderr
    assert "uncaught exception in main" in r.stderr
    assert r.stderr.count("missing.py") >= 2  # logged, then Python's
    assert r.stderr.rstrip().splitlines()[-1].startswith("FileNotFoundError")
    r = subprocess.run(run + ["-f", "load_eval/yolox_24p_eval.py",
                              "--device", "cpu"], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 1 and "--data-dir" in r.stderr
    assert "uncaught exception" not in r.stderr
