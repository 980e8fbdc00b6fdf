"""The port's serving slice on the CPU: letterboxes against JAX and cv2, the
whole serving function against the JAX package's, and the batched service
behind the threaded HTTP front end."""

import json
import sys
import threading
import time
import tracemalloc
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.data.transforms import letterbox_batch_device as jax_letterbox
from eop_tpu.exp.yolox_24p_base import Exp24P as JaxExp24P
from eop_tpu.models import init_model
from eop_tpu_torch.data.image_io import declared_size, imdecode
from eop_tpu_torch.data.transforms import letterbox_batch_device, letterbox_host
from eop_tpu_torch.exp import Exp24P
from eop_tpu_torch.serving.batcher import DynamicBatcher, QueueFullError
from eop_tpu_torch.serving.http import (
    MAX_PIXELS,
    decode_request_image,
    make_http_server,
)
from eop_tpu_torch.serving.service import DetectionService
from eop_tpu_torch.utils.synth import encode_jpeg, encode_png, write_bmp
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
    """A kind the port does not decode (here a progressive JPEG: its SOF
    says so) is 415, naming it, where the server has no cv2."""
    *_, base = http_service
    body = bytearray(encode_jpeg(images(3, (20, 30, 3))))
    sof = body.index(b"\xff\xc0")
    body[sof + 1] = 0xC2
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    code, payload = post(base + "/v1/detect", bytes(body))
    assert code == 415 and "cv2" in payload["error"]
    assert "progressive JPEG" in payload["error"]
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        assert json.loads(r.read())["status"] == "ok"


@pytest.mark.parametrize("kind", ["jpeg", "png", "bmp"])
def test_http_encoded_bodies_answer_as_their_decoded_pixels(
        http_service, monkeypatch, kind, tmp_path):
    """JPEG, PNG and BMP bodies decode without cv2, and each answer equals
    the answer to the raw body of the decoded pixels (posted one at a time,
    so both run alone in the same bucket)."""
    *_, base = http_service
    img = images(21, (52, 70, 3))
    if kind == "bmp":
        write_bmp(str(tmp_path / "a.bmp"), img)
        body = (tmp_path / "a.bmp").read_bytes()
    else:
        body = encode_jpeg(img) if kind == "jpeg" else encode_png(img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    pixels = imdecode(body)
    if kind != "jpeg":
        np.testing.assert_array_equal(pixels, img)
    code, payload = post(base + "/v1/detect", body)
    raw_code, raw_payload = post(base + "/v1/detect", pixels.tobytes(),
                                 {"X-Raw-Shape": "52,70,3"})
    assert code == raw_code == 200
    assert payload["image_hw"] == [52, 70]
    assert len(payload["detections"]) > 0
    assert payload["detections"] == raw_payload["detections"]


def test_http_corrupt_encoded_body_is_400(http_service, monkeypatch):
    *_, base = http_service
    body = encode_jpeg(images(4, (40, 40, 3)))
    monkeypatch.setitem(sys.modules, "cv2", None)
    code, payload = post(base + "/v1/detect", body[:len(body) // 2])
    assert code == 400 and "truncated JPEG data" in payload["error"]


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return (len(body).to_bytes(4, "big") + kind + body
            + zlib.crc32(kind + body).to_bytes(4, "big"))


def forge_size(body: bytes, kind: str, w: int, h: int) -> bytes:
    """``body`` with the width and height its header declares replaced."""
    buf = bytearray(body)
    if kind == "jpeg":
        at = buf.index(b"\xff\xc0") + 5
        buf[at:at + 4] = h.to_bytes(2, "big") + w.to_bytes(2, "big")
    elif kind == "png":
        ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + buf[24:29]
        buf[8:33] = png_chunk(b"IHDR", bytes(ihdr))
    else:
        buf[18:26] = w.to_bytes(4, "little") + h.to_bytes(4, "little")
    return bytes(buf)


@pytest.mark.parametrize("kind", ["jpeg", "png", "bmp"])
def test_declared_size_and_bomb_rejection(kind, tmp_path):
    """The size a header declares is the decoded image's, and a header that
    declares more than MAX_PIXELS is 413 before any decode."""
    img = images(5, (37, 53, 3))
    if kind == "bmp":
        write_bmp(str(tmp_path / "a.bmp"), img)
        body = (tmp_path / "a.bmp").read_bytes()
    else:
        body = encode_jpeg(img) if kind == "jpeg" else encode_png(img)
    assert declared_size(body) == (53, 37)
    assert imdecode(body).shape == (37, 53, 3)
    big = forge_size(body, kind, 50000, 50000)
    assert declared_size(big) == (50000, 50000)
    assert 50000 * 50000 > MAX_PIXELS
    img, (code, payload) = decode_request_image(big, None)
    assert img is None and code == 413, payload


def test_unknown_or_corrupt_headers_are_400():
    assert declared_size(b"GIF89a" + b"\0" * 64) is None
    _, (code, _) = decode_request_image(b"GIF89a" + b"\0" * 64, None)
    assert code == 400
    jpeg = encode_jpeg(images(6, (20, 30, 3)))
    head = jpeg[:jpeg.index(b"\xff\xda")]  # headers that end before a scan
    _, (code, payload) = decode_request_image(head, None)
    assert code == 400 and "truncated JPEG data" in payload["error"]


def png_bomb(inflated_mib: int) -> bytes:
    """A 1x1 RGB PNG whose IDAT stream inflates to ``inflated_mib`` MiB: its
    one row (filter 0, BGR 30 20 10), then zeros."""
    z = zlib.compressobj(9)
    zeros = bytes(1 << 20)
    idat = b"".join([z.compress(bytes([0, 10, 20, 30]))]
                    + [z.compress(zeros) for _ in range(inflated_mib)]
                    + [z.flush()])
    ihdr = (1).to_bytes(4, "big") * 2 + bytes([8, 2, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", ihdr)
            + png_chunk(b"IDAT", idat) + png_chunk(b"IEND", b""))


def test_http_png_bomb_decodes_in_bounded_memory(http_service, monkeypatch):
    """A 1x1 PNG whose IDAT inflates to 128 MiB: only the rows the header
    declares are inflated (libpng, under cv2.imdecode, decodes the same
    pixel and warns of the rest), so the body decodes in a few MiB and is
    answered as the raw pixel is."""
    *_, base = http_service
    body = png_bomb(128)
    assert len(body) < 1 << 20
    monkeypatch.setitem(sys.modules, "cv2", None)
    tracemalloc.start()
    try:
        img, err = decode_request_image(body, None)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert err is None and img.tolist() == [[[30, 20, 10]]]
    assert peak < 8 << 20, peak
    code, payload = post(base + "/v1/detect", body)
    raw_code, raw_payload = post(base + "/v1/detect", img.tobytes(),
                                 {"X-Raw-Shape": "1,1,3"})
    assert code == raw_code == 200
    assert payload["image_hw"] == [1, 1]
    assert payload["detections"] == raw_payload["detections"]


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


def test_serve_cli_reads_a_bf16_exp_file(bridged, tmp_path):
    """``serve -f``: an exp file with ``compute_dtype "bfloat16"`` (parsed,
    not imported) serves fp32 weights through the bf16 model; its answers
    are those of the exp's own bf16 serving function on the same weights."""
    from eop_tpu_torch.tools import serve as cli

    *_, exp, model = bridged
    weights = tmp_path / "tiny.pth"
    torch.save(model.state_dict(), weights)
    exp_file = tmp_path / "exp_bf16.py"
    exp_file.write_text(
        "from eop_tpu.exp import Exp24P as _Base\n\n\n"
        "class Exp(_Base):\n    def __init__(self):\n"
        "        super().__init__()\n"
        "        self.depth, self.width = 0.33, 0.125\n"
        "        self.num_classes = 3\n"
        '        self.compute_dtype = "bfloat16"\n'
        "        self.test_size = (64, 64)\n")
    args = cli.make_parser().parse_args([
        "-f", str(exp_file), "--device", "cpu", "--batch", "2", "-w",
        str(weights), "test_conf", "5e-5"])
    svc = cli.build_service(args)
    try:
        img = images(31, (64, 64, 3))
        dets = svc.detect(img)
    finally:
        svc.close()
    bf16 = tiny(Exp24P())
    bf16.compute_dtype, bf16.test_conf = "bfloat16", 5e-5
    ref_model = bf16.get_model("cpu")
    ref_model.load_state_dict(model.state_dict(), strict=True)
    assert ref_model.head.dtype == torch.bfloat16
    out = bf16.get_serving_fn(ref_model, (64, 64), "cpu")(img[None])
    assert len(dets) == int(out.valid.sum()) > 0
    rows = out.rows[0][out.valid[0]]
    np.testing.assert_allclose([d["score"] for d in dets],
                               (rows[:, 26] * rows[:, 27]).numpy(),
                               rtol=1e-6)
