"""Serving the bbox family in the port against the JAX package: the fused
serving function (uint8 letterbox on the device, forward, decode, NMS) of a
small YOLOX (depth 0.33, width 0.125, 3 classes, 64 px) at a canvas other
than ``test_size``, the service's detection dicts of both row widths, and
``tools.serve -n yolox-s`` answering HTTP with ``bbox`` dicts on the CPU.
Rows within 1e-4 (absolute and relative), ``valid`` equal."""

import json
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.exp import Exp as JExp
from eop_tpu.serving.service import DetectionService as JService
from eop_tpu_torch.exp import Exp
from eop_tpu_torch.serving.service import DetectionService
from eop_tpu_torch.utils.weights import state_dict_from_jax

SIZE, CLASSES = 64, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(exp):
    exp.depth, exp.width, exp.num_classes = 0.33, 0.125, CLASSES
    exp.test_size, exp.test_conf = (SIZE, SIZE), 0.05
    return exp


def random_variables(module, seed=0):
    """numpy variables of ``module``'s init shapes (``jax.eval_shape``, no
    compile), BatchNorm away from the identity."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), False))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.uniform(0.5, 1.5, s.shape) if len(s.shape) == 1
                   else rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                   ).astype(np.float32), dict(shapes))


@pytest.fixture(scope="module")
def bridged():
    jexp = small(JExp())
    jexp.packed_early = False
    jmodel = jexp.get_model()
    variables = random_variables(jmodel)
    exp = small(Exp())
    model = exp.get_model("cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jexp, jmodel, variables, exp, model


def images(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


def test_bbox_serving_fn_matches_jax(bridged):
    """uint8 ``[2, 48, 80, 3]`` -> letterbox to 64 px on the device ->
    forward -> ``postprocess_bbox_heads``: rows ``[2, 300, 7]``."""
    jexp, jmodel, variables, exp, model = bridged
    src_hw = (48, 80)
    raw = images(2, (2, *src_hw, 3))
    want = jax.jit(jexp.get_serving_fn(jmodel, variables, src_hw))(
        jnp.asarray(raw))
    got = exp.get_serving_fn(model, src_hw, "cpu")(raw)
    valid = np.asarray(want.valid)
    assert got.rows.shape == (2, 300, 7) and valid.sum() > 4
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.rows.numpy()[valid],
                               np.asarray(want.rows)[valid],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("width", [7, 29])
def test_to_dicts_match_eop_tpu_service(width):
    """The same rows through both services' ``_to_dicts`` (coordinates
    divided by the device and host ratios, class names): equal dicts, with
    ``bbox`` at width 7 and ``center`` / ``radii`` / ``points`` at 29."""
    rng = np.random.RandomState(width)
    rows = rng.uniform(1, 60, (12, width)).astype(np.float32)
    rows[:, -3:-1] = rng.uniform(0, 1, (12, 2))
    rows[:, -1] = rng.randint(0, CLASSES, 12)
    valid = rng.rand(12) < 0.6
    host = dict(dev_ratio=0.8, class_names=["a", "b", "c"])
    got = DetectionService._to_dicts(types.SimpleNamespace(**host), rows,
                                     valid, 0.5)
    want = JService._to_dicts(types.SimpleNamespace(**host), rows, valid, 0.5)
    assert len(got) == valid.sum() > 0
    assert got == want
    assert ("bbox" in got[0]) == (width == 7)
    with pytest.raises(ValueError, match="width 9"):
        DetectionService._to_dicts(types.SimpleNamespace(**host),
                                   np.zeros((12, 9), np.float32), valid, 0.5)


def test_serve_cli_answers_bbox_dicts_over_http(bridged, tmp_path):
    """``tools.serve -n yolox-s -w CKPT --device cpu`` with shrunken
    overrides: a POST gets ``bbox`` dicts in the posted image's pixels, the
    direct serving call's detections, and COCO class names at 80
    classes."""
    from eop_tpu_torch.serving.http import make_http_server
    from eop_tpu_torch.tools import serve as cli

    *_, exp, model = bridged
    path = tmp_path / "small.pth"
    torch.save(model.state_dict(), path)
    args = cli.make_parser().parse_args([
        "-n", "yolox-s", "--device", "cpu", "--batch", "2", "-w", str(path),
        "width", "0.125", "num_classes", "3", "test_size", "(64, 64)",
        "test_conf", "0.05"])
    svc = cli.build_service(args)
    server = make_http_server(svc, host="127.0.0.1", port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        img = images(7, (64, 64, 3))
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/detect",
            data=img.tobytes(), method="POST",
            headers={"X-Raw-Shape": "64,64,3"})
        with urllib.request.urlopen(req, timeout=60) as r:
            status, body = r.status, json.loads(r.read())
        out = exp.get_serving_fn(model, (64, 64), "cpu")(img[None])
        rows = out.rows[0][out.valid[0]].numpy()
        assert status == 200
        dets = body["detections"]
        assert len(dets) == len(rows) > 0
        for det, row in zip(dets, rows):
            np.testing.assert_allclose(det["bbox"], row[:4], atol=1e-4)
            assert "class_name" not in det and "points" not in det
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        t.join(timeout=10)
    coco = cli.build_service(cli.make_parser().parse_args([
        "-n", "yolox-nano", "--device", "cpu", "--batch", "1",
        "test_size", "(64, 64)"]))
    try:
        assert coco.class_names[0] == "person" and len(coco.class_names) == 80
        assert coco.test_size == (64, 64)
    finally:
        coco.close()
