"""The port's serving slice on the CPU: letterboxes against JAX and cv2, the
whole serving function against the JAX package's, and the batched service
behind the threaded HTTP front end."""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.data.transforms import letterbox_batch_device as jax_letterbox
from eop_tpu.exp.yolox_24p_base import Exp24P as JaxExp24P
from eop_tpu.models import init_model
from eop_tpu_torch.data.transforms import letterbox_batch_device, letterbox_host
from eop_tpu_torch.exp import Exp24P
from eop_tpu_torch.serving.batcher import DynamicBatcher, QueueFullError
from eop_tpu_torch.serving.http import make_http_server
from eop_tpu_torch.serving.service import DetectionService
from eop_tpu_torch.utils.weights import state_dict_from_jax


def tiny(exp):
    exp.depth, exp.width, exp.num_classes = 0.33, 0.125, 3
    exp.test_size = (64, 64)
    # random-init scores sit near the squared 0.01 prior (1e-4)
    exp.test_conf = 5e-5
    return exp


def images(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


@pytest.mark.parametrize("src_hw", [(96, 128), (64, 64)])
def test_device_letterbox_matches_jax(src_hw):
    x = images(0, (2, *src_hw, 3)).astype(np.float32)
    want, r_want = jax_letterbox(jnp.asarray(x), src_hw, (64, 64))
    got, r = letterbox_batch_device(torch.from_numpy(x), src_hw, (64, 64))
    assert r == r_want
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("img_hw,src_hw", [
    ((48, 64), (36, 48)), ((108, 192), (72, 128)), ((30, 50), (38, 64)),
])
def test_host_letterbox_within_one_level_of_cv2(img_hw, src_hw):
    cv2 = pytest.importorskip("cv2")
    img = images(1, (*img_hw, 3))
    got, r = letterbox_host(img, src_hw)
    h, w = img_hw
    nh, nw = int(h * r), int(w * r)
    want = np.full((*src_hw, 3), 114, np.uint8)
    want[:nh, :nw] = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def bridged():
    jexp = tiny(JaxExp24P())
    jmodel = jexp.get_model()
    variables = jax.tree_util.tree_map(np.asarray, init_model(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    exp = tiny(Exp24P())
    model = exp.get_model("cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jexp, jmodel, variables, exp, model


def test_serving_fn_matches_jax_end_to_end(bridged):
    """uint8 batch -> downscaling letterbox -> forward -> postprocess."""
    jexp, jmodel, variables, exp, model = bridged
    src_hw = (96, 128)
    raw = images(2, (2, *src_hw, 3))
    want = jexp.get_serving_fn(jmodel, variables, src_hw)(jnp.asarray(raw))
    got = exp.get_serving_fn(model, src_hw, "cpu")(raw)
    valid = np.asarray(want.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.rows.numpy()[valid],
                               np.asarray(want.rows)[valid],
                               atol=1e-4, rtol=1e-4)


def test_entry_points_default_to_cuda_and_raise_without_it(bridged,
                                                           monkeypatch):
    *_, exp, model = bridged
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp.get_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp.get_serving_fn(model, (64, 64))


@pytest.fixture(scope="module")
def http_service(bridged):
    *_, exp, model = bridged
    svc = DetectionService.from_exp(exp, model, batch=4, src_hw=(48, 80),
                                    device="cpu", max_wait_ms=20.0,
                                    class_names=["a", "b", "c"])
    server = make_http_server(svc, host="127.0.0.1", port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield svc, exp, model, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    svc.close()
    t.join(timeout=10)
    assert not t.is_alive()


def post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_concurrent_raw_requests_unmap_coordinates(http_service):
    svc, exp, model, base = http_service
    imgs = [images(10 + i, (60 + 8 * i, 100, 3)) for i in range(6)]
    results = [None] * len(imgs)

    def worker(i):
        results[i] = post(base + "/v1/detect", imgs[i].tobytes(),
                          {"X-Raw-Shape": "%d,%d,3" % imgs[i].shape[:2]})

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(not t.is_alive() for t in threads)
    assert [code for code, _ in results] == [200] * len(imgs)
    stats = svc.stats()
    assert stats["requests"] == len(imgs)
    assert stats["batches"] < len(imgs), "concurrent requests never batched"
    # + one warmup call per bucket
    assert stats["device_calls"] == stats["batches"] + len(svc.buckets)

    # by hand: host letterbox -> serving function (bucket 1) -> unscale
    serve = exp.get_serving_fn(model, svc.src_hw, "cpu")
    for img, (_, payload) in zip(imgs, results):
        assert payload["image_hw"] == list(img.shape[:2])
        canvas, r_host = letterbox_host(img, svc.src_hw)
        out = serve(canvas[None])
        valid = out.valid[0].numpy()
        rows = out.rows[0].numpy()[valid]
        dets = payload["detections"]
        assert len(dets) == len(rows) > 0
        ratio = svc.dev_ratio * r_host
        np.testing.assert_allclose([d["center"] for d in dets],
                                   rows[:, :2] / ratio, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose([d["radii"] for d in dets],
                                   rows[:, 2:26] / ratio, rtol=1e-4, atol=1e-3)
        d0 = dets[0]
        assert d0["class_name"] in ("a", "b", "c")
        np.testing.assert_allclose(
            d0["points"][0], [d0["center"][0] + d0["radii"][0],
                              d0["center"][1]], rtol=1e-5)


@pytest.mark.parametrize("shape_hdr,nbytes", [
    ("-1,4,3", 48),    # a negative dim numpy would infer
    ("0,4,3", 12),     # zero-size image
    ("4,4,3", 47),     # byte count mismatch
    ("4,4,1", 16),     # not 3 channels
    ("4,x,3", 48),     # not an int
])
def test_http_rejects_bad_raw_shape(http_service, shape_hdr, nbytes):
    *_, base = http_service
    code, payload = post(base + "/v1/detect", b"\0" * nbytes,
                         {"X-Raw-Shape": shape_hdr})
    assert code == 400, payload


def test_http_encoded_image_without_cv2_is_415(http_service, monkeypatch):
    *_, base = http_service
    png = b"\x89PNG\r\n\x1a\n" + b"\0" * 8 + (8).to_bytes(4, "big") * 2
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    code, payload = post(base + "/v1/detect", png + b"\0" * 16)
    assert code == 415 and "cv2" in payload["error"]
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        assert json.loads(r.read())["status"] == "ok"


def test_batcher_coalesces_and_sheds_load():
    sizes = []
    release = threading.Event()

    def run(items):
        sizes.append(len(items))
        release.wait(10)
        return [x * 2 for x in items]

    b = DynamicBatcher(run, max_batch=4, max_wait_ms=200, max_queue=2)
    results = {}
    ts = [threading.Thread(target=lambda i=i: results.update({i: b.submit(i)}))
          for i in range(3)]
    for t in ts:
        t.start()
    deadline = time.time() + 10
    # the dispatcher holds one batch and the first three are all admitted
    # (a thread started late may have missed that batch and wait queued)
    while ((not sizes or sum(sizes) + b.stats()["queue_depth"] < 3)
           and time.time() < deadline):
        time.sleep(0.01)
    # fill the queue behind the batch in flight
    fill = range(3, 3 + 2 - b.stats()["queue_depth"])
    more = [threading.Thread(target=lambda i=i: results.update(
        {i: b.submit(i)})) for i in fill]
    for t in more:
        t.start()
    while b.stats()["queue_depth"] < 2 and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(QueueFullError):
        b.submit(99)
    release.set()
    for t in ts + more:
        t.join(timeout=10)
    b.close()
    n = 3 + len(fill)
    assert results == {i: 2 * i for i in range(n)}
    assert max(sizes) >= 2 and sum(sizes) == n


def test_exp_merge_grammar_and_preset():
    from eop_tpu_torch.exp import get_exp

    exp = get_exp(exp_name="yolox_24p_s")
    assert (exp.depth, exp.width, exp.num_classes) == (0.33, 0.50, 80)
    exp.merge(["test_conf", "0.3", "test_size", "(320, 320)",
               "reference_parity", "True", "num_classes", "3",
               "nms_mode", "budget"])
    assert exp.test_conf == 0.3 and exp.test_size == (320, 320)
    assert exp.reference_parity is True and exp.num_classes == 3
    assert exp._nms_iters() == 64
    exp.merge(["max_epoch", "3"])   # a training field, known since the trainer
    assert exp.max_epoch == 3
    with pytest.raises(KeyError):
        exp.merge(["no_such_field", "3"])
    with pytest.raises(ValueError):
        exp.merge(["test_conf"])
    with pytest.raises(ValueError):
        get_exp(exp_name="yolox_24p_x")


def test_serve_cli_loads_weights_strictly_on_the_cpu(bridged, tmp_path):
    from eop_tpu_torch.tools import serve as cli

    *_, exp, model = bridged
    path = tmp_path / "tiny.pth"
    torch.save(model.state_dict(), path)
    args = cli.make_parser().parse_args([
        "--device", "cpu", "--batch", "2", "-w", str(path),
        "width", "0.125", "num_classes", "3", "test_size", "(64, 64)",
        "test_conf", "5e-5"])
    svc = cli.build_service(args)
    try:
        img = images(30, (64, 64, 3))
        dets = svc.detect(img)
        out = exp.get_serving_fn(model, (64, 64), "cpu")(img[None])
        assert len(dets) == int(out.valid.sum()) > 0
        assert svc.buckets == [1, 2]
    finally:
        svc.close()
    bad = {k: v for k, v in model.state_dict().items() if "head" not in k}
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        cli.build_service(args)
