"""The port's serving artifact (``eop_tpu_torch/utils/serving_export.py``,
``tools/export_serving.py``, ``serve --artifact``) on the CPU: the
counterpart of ``tests/test_serving_export.py`` and
``tests/test_quant.py::test_quant_serving_export_roundtrip``.

A ``torch.export`` artifact of the fused serving program gives the port's
live serving function's answer bit for bit, and ``eop_tpu``'s live serving
function's within the serve parity tolerance (valid masks equal, rows 1e-4:
``tests/test_torch_serving.py``).  Weights go across with ``eop_tpu``'s
importer and ``state_dict_from_jax``.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.exp import Exp as JaxExp
from eop_tpu.exp.yolox_24p_base import Exp24P as JaxExp24P
from eop_tpu.utils.torch_import import convert_state_dict
from eop_tpu_torch.exp import Exp, Exp24P
from eop_tpu_torch.ops import nms as nms_ops
from eop_tpu_torch.ops import quant
from eop_tpu_torch.ops.blocks import BaseConv
from eop_tpu_torch.serving.service import DetectionService
from eop_tpu_torch.tools import export_serving as export_cli
from eop_tpu_torch.tools import serve as serve_cli
from eop_tpu_torch.utils.serving_export import (
    artifact_input_shape,
    check_platforms,
    export_serving,
    load_serving_artifact,
    save_serving_artifact,
)
from eop_tpu_torch.utils.synth import write_24p_dataset
from eop_tpu_torch.utils.weights import unmap_key

ROOT = Path(__file__).resolve().parents[1]
SRC_HW, BATCH, MIN_CH = (48, 80), 2, 16
TINY = ["depth", "0.33", "width", "0.125", "num_classes", "3",
        "test_size", "(64, 64)", "test_conf", "5e-5"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(exp):
    exp.depth, exp.width, exp.num_classes = 0.33, 0.125, 3
    exp.input_size = exp.test_size = (64, 64)
    # random-init scores sit near the squared 0.01 prior (1e-4)
    exp.test_conf = 5e-5
    return exp


def raw_frames(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (BATCH, *SRC_HW, 3),
                                               np.uint8)


CASES = {"bbox": (JaxExp, Exp, False), "24p": (JaxExp24P, Exp24P, False),
         "24p_int8": (JaxExp24P, Exp24P, True)}


def _build(case, root):
    """(case, port exp, the model exported, quant scales, the artifact's
    path, the loaded program, eop_tpu's live serving answer)."""
    jfam, fam, int8 = CASES[case]
    exp = tiny(fam())
    model = exp.get_model("cpu")
    jexp = tiny(jfam())
    jexp.packed_early = False
    jmodel = jexp.get_model()
    variables = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    jscales = scales = None
    if int8:
        calib = [np.random.RandomState(3).rand(2, 64, 64, 3).astype(
            np.float32) * 255]
        variables, jscales = jexp.quantize_for_inference(
            jmodel, variables, calib, MIN_CH)
        # eop_tpu's scales in the port's names, so the two quantize alike
        scales = {unmap_key(k.replace("/", ".")): v
                  for k, v in jscales.items()}
        model, _ = exp.quantize_for_inference(model, calib, MIN_CH)
    want = jexp.get_serving_fn(jmodel, variables, SRC_HW,
                               quant_scales=jscales,
                               quant_min_channels=MIN_CH)(
        jnp.asarray(raw_frames()))
    prog = export_serving(exp, model, BATCH, SRC_HW, "cpu", scales, MIN_CH)
    path = str(root / f"{case}.pt2")
    meta = {"test_size": [64, 64], "src_hw": list(SRC_HW), "batch": BATCH,
            "num_classes": 3, "int8": int8, "platforms": ["cpu"],
            "class_names": ["a", "b", "c"]}
    assert save_serving_artifact(prog, path, meta) > 10_000
    return (case, exp, model, scales, path, load_serving_artifact(path, "cpu"),
            jax.tree_util.tree_map(np.asarray, want))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """case -> :func:`_build`'s tuple, each built once, when first asked."""
    root, built = tmp_path_factory.mktemp("art"), {}

    def get(case):
        if case not in built:
            built[case] = _build(case, root)
        return built[case]

    return get


@pytest.fixture(params=sorted(CASES))
def exported(request, artifacts):
    return artifacts(request.param)


def test_artifact_equals_live_serving_and_eop_tpu(exported):
    case, exp, model, scales, path, prog, want = exported
    raw = raw_frames()
    live = exp.get_serving_fn(model, SRC_HW, "cpu", scales, MIN_CH)(raw)
    assert artifact_input_shape(prog) == (BATCH, *SRC_HW, 3)
    with torch.no_grad():
        rows, valid = prog.module()(torch.from_numpy(raw))
    np.testing.assert_array_equal(valid.numpy(), live.valid.numpy())
    np.testing.assert_array_equal(rows.numpy(), live.rows.numpy())
    # against eop_tpu's live serving function (fp32, or int8 on eop_tpu's
    # scales): the serve parity tolerance
    v = want.valid
    assert v.sum() > 0
    np.testing.assert_array_equal(valid.numpy(), v)
    np.testing.assert_allclose(rows.numpy()[v], want.rows[v], atol=1e-4,
                               rtol=1e-4)


def test_graph_holds_the_registered_operators(exported):
    case, exp, model, scales, path, prog, _ = exported
    targets = [str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"]
    phase = [m for m in model.modules()
             if isinstance(m, BaseConv) and m.phase_conv]
    assert len(phase) == 8
    n_phase = targets.count("eop_tpu_torch.phase_conv.default")
    n_int8 = targets.count("eop_tpu_torch.int8_conv.default")
    if scales is None:
        assert (n_phase, n_int8) == (8, 0)
    else:
        qmodel = quant.quantize_model(model, scales, MIN_CH)
        n_q = sum(isinstance(m, quant.QuantConv2d) for m in qmodel.modules())
        left = sum(isinstance(m, BaseConv) and m.phase_conv
                   for m in qmodel.modules())
        assert (n_phase, n_int8) == (left, n_q)
        assert 0 < left < 8 and n_q > 0
    assert any("while_loop" in t for t in targets)


def greedy_keep(boxes, scores, thr):
    """Plain greedy NMS over score order, the ground truth."""
    order = np.argsort(-scores, kind="mergesort")
    keep = np.zeros(len(boxes), bool)
    dead = np.zeros(len(boxes), bool)
    x1, y1, x2, y2 = boxes.T
    area = (x2 - x1) * (y2 - y1)
    for i in order:
        if dead[i]:
            continue
        keep[i] = True
        inter = (np.clip(np.minimum(x2[i], x2) - np.maximum(x1[i], x1), 0,
                         None)
                 * np.clip(np.minimum(y2[i], y2) - np.maximum(y1[i], y1), 0,
                           None))
        dead |= inter / (area[i] + area - inter) > thr
    return keep


class _Suppress(torch.nn.Module):
    def forward(self, boxes, valid):
        return nms_ops.nms_on_candidates(boxes, valid, 0.65,
                                         fixpoint_iters="exact")


def test_exported_exact_nms_survives_a_deep_chain(tmp_path):
    """K boxes along a line, each overlapping its neighbour above the
    threshold (tests/test_nms_adversarial.py's chain): suppression depth
    about K, far past a 64-step budget."""
    k = 200
    overlap = 2 * 10.0 * 0.75 / 1.75
    x1 = np.arange(k) * (10.0 - overlap)
    boxes = np.stack([x1, np.zeros(k), x1 + 10.0, np.ones(k)],
                     1).astype(np.float32)
    truth = greedy_keep(boxes, np.linspace(1, 0.5, k), 0.65)
    b = torch.from_numpy(boxes)[None].repeat(2, 1, 1)
    valid = torch.ones((2, k), dtype=torch.bool)
    valid[1, 150:] = False
    eager = nms_ops.nms_on_candidates(b, valid, 0.65, fixpoint_iters="exact")
    budget = nms_ops.nms_on_candidates(b, valid, 0.65, fixpoint_iters=64)
    np.testing.assert_array_equal(eager[0].numpy(), truth)
    assert not torch.equal(budget, eager)
    with torch.no_grad():
        prog = torch.export.export(_Suppress(), (b, valid))
    path = str(tmp_path / "nms.pt2")
    torch.export.save(prog, path)
    got = torch.export.load(path).module()(b, valid)
    assert torch.equal(got, eager)


def test_loads_in_a_fresh_process_without_model_code(artifacts):
    path = artifacts("24p_int8")[4]
    code = (
        "import sys, torch\n"
        "from eop_tpu_torch.utils.serving_export import "
        "load_serving_artifact, artifact_input_shape\n"
        f"prog, meta = load_serving_artifact({path!r}, 'cpu', "
        "with_meta=True)\n"
        "x = torch.zeros(artifact_input_shape(prog), dtype=torch.uint8)\n"
        "rows, valid = prog.module()(x)\n"
        "assert not any(m.startswith(('eop_tpu_torch.exp', "
        "'eop_tpu_torch.models')) for m in sys.modules)\n"
        "print(tuple(rows.shape), tuple(valid.shape), meta['test_size'])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split("\n")[-2] == "(2, 300, 29) (2, 300) [64, 64]"


def test_jax_blob_and_wrong_platforms_raise(tmp_path):
    blob = tmp_path / "serving.stablehlo"
    head = json.dumps({"test_size": [64, 64]}).encode()
    blob.write_bytes(b"EOPSRV1\n" + len(head).to_bytes(4, "big") + head
                     + b"\x00" * 64)
    with pytest.raises(ValueError, match="EOPSRV1 StableHLO"):
        load_serving_artifact(str(blob), "cpu")
    for bad in (["tpu"], ["cuda", "rocm"], []):
        with pytest.raises(ValueError, match=repr(bad[-1]) if bad else "no"):
            check_platforms(bad)
    assert check_platforms(["CUDA", " cpu"]) == ("cuda", "cpu")
    # an artifact meant for the card only does not load on the CPU
    with torch.no_grad():
        prog = torch.export.export(_Suppress(), (
            torch.zeros((1, 4, 4)), torch.ones((1, 4), dtype=torch.bool)))
    cuda_only = str(tmp_path / "cuda_only.pt2")
    save_serving_artifact(prog, cuda_only, {"test_size": [64, 64],
                                            "platforms": ["cuda"]})
    with pytest.raises(ValueError, match=r"exported for \['cuda'\]"):
        load_serving_artifact(cuda_only, "cpu")


def test_from_artifact_reads_the_metadata(artifacts):
    case = "bbox"
    path = artifacts(case)[4]
    svc = DetectionService.from_artifact(path, device="cpu",
                                         max_wait_ms=1.0)
    try:
        assert svc.batch == BATCH and svc.buckets == [BATCH]
        assert svc.src_hw == SRC_HW and svc.test_size == (64, 64)
        assert svc.class_names == ["a", "b", "c"]
        dets = svc.detect(raw_frames(1)[0])
        assert dets and all(d["class_name"] in "abc" for d in dets)
        assert "bbox" in dets[0]
        assert svc.stats()["bucket_hits"] == {str(BATCH): 1}
    finally:
        svc.close()
    # serve --artifact builds the same service
    svc = serve_cli.build_service(serve_cli.make_parser().parse_args(
        ["--artifact", path, "--device", "cpu"]))
    try:
        assert (svc.batch, svc.src_hw, svc.test_size) == (BATCH, SRC_HW,
                                                          (64, 64))
    finally:
        svc.close()


def test_export_command_line_int8_smoke(tmp_path, capsys):
    img_dir, _ = write_24p_dataset(str(tmp_path / "calib"), 2, (90, 160),
                                   seed=5)
    out = str(tmp_path / "cli.pt2")
    export_cli.main(["--batch", "2", "--src-hw", "48,80", "--out", out,
                     "--device", "cpu", "--int8", "--calib", img_dir,
                     "--quant-min-channels", str(MIN_CH), "--smoke", *TINY])
    text = capsys.readouterr().out
    m = re.search(r"int8 PTQ: (\d+) convs quantized \(min_channels=16\)",
                  text)
    assert m and int(m.group(1)) > 0
    assert re.search(r"exported .*cli\.pt2: [0-9.]+ MB in [0-9.]+ s, "
                     r"platforms=cpu, input=uint8\[2,48,80,3\]", text)
    assert "smoke: rows(2, 300, 29) valid(2, 300) n_det=" in text


@pytest.mark.parametrize("extra", [
    ["--batch", "2"], ["--src-hw", "48,80"], ["-n", "yolox-s"],
    ["-f", "load_eval/yolox_24p_eval.py"], ["-w", "w.pth"], ["--int8"],
    ["--calib", "imgs"], ["width", "0.25"]])
def test_serve_artifact_rejects_what_the_artifact_fixes(extra):
    args = serve_cli.make_parser().parse_args(
        ["--artifact", "a.pt2", "--device", "cpu", *extra])
    with pytest.raises(SystemExit, match="baked into the artifact"):
        serve_cli.build_service(args)
