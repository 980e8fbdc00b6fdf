"""The demo against ``eop_tpu``'s on the CPU:

* ``utils/demo_utils.py`` against ``eop_tpu.utils.demo_utils`` on seeded
  boxes, ties and empty results included: keep lists and rows equal,
  ``demo_postprocess`` bit-equal (p6 too);
* ``python -m eop_tpu_torch.tools.demo --device cpu`` against
  ``tools/demo.py``'s ``Demo`` (loaded by path) for a 24p and a bbox exp
  (depth 0.33, width 0.25, 128 px), both reading one reference-form
  ``.pth`` made from the JAX model's own ``PRNGKey(0)`` weights
  (``state_dict_from_jax``): the images are at ``test_size``, so neither
  side resizes; the kept rows within 1e-4, the annotated images (PNG,
  lossless) bit-equal to ``Demo.draw``'s;
* the command line on a folder, on one file, with ``--int8`` (its conv
  count is ``ops/quant.py``'s), and on a 3-frame video against
  ``eop_tpu``'s ``run_video`` (equal frame counts); with cv2 made
  unimportable, ``.webp`` output and video raise naming OpenCV and a
  progressive JPEG raises naming the file.
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from eop_tpu.utils import demo_utils as ref_utils
from eop_tpu_torch.data.image_io import imread
from eop_tpu_torch.tools import demo
from eop_tpu_torch.utils import demo_utils
from eop_tpu_torch.utils.synth import write_jpeg, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128
TINY = ["depth", "0.33", "width", "0.25", "num_classes", "80",
        "test_size", f"({SIZE}, {SIZE})"]
CONF = "0.3"
EXPS = {"24p": ["-f", "load_eval/yolox_24p_eval.py"],
        "bbox": ["-n", "yolox-s"]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# demo_utils
# ---------------------------------------------------------------------------

def seeded_boxes(n, seed, ties=False):
    """``n`` boxes clustered so that many overlap, and scores ``[n, 3]``
    (quantised to tenths with ``ties``, so equal scores meet)."""
    rng = np.random.RandomState(seed)
    centre = rng.uniform(20, 80, (n, 2))
    half = rng.uniform(5, 25, (n, 2))
    boxes = np.concatenate([centre - half, centre + half], 1)
    scores = rng.uniform(0, 1, (n, 3))
    if ties:
        scores = np.round(scores, 1)
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_keeps_eop_tpu_s_list(seed, ties):
    boxes, scores = seeded_boxes(40, seed, ties)
    for thr in (0.3, 0.45, 0.7):
        assert demo_utils.nms(boxes, scores[:, 0], thr) == ref_utils.nms(
            boxes, scores[:, 0], thr)


@pytest.mark.parametrize("agnostic", [True, False],
                         ids=["agnostic", "aware"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_multiclass_nms_rows_equal_eop_tpu_s(agnostic, ties):
    boxes, scores = seeded_boxes(50, 3, ties)
    for score_thr in (0.1, 0.5, 0.9, 1.5):  # 1.5: nothing passes
        got = demo_utils.multiclass_nms(boxes, scores, 0.45, score_thr,
                                        class_agnostic=agnostic)
        want = ref_utils.multiclass_nms(boxes, scores, 0.45, score_thr,
                                        class_agnostic=agnostic)
        if want is None:
            assert got is None and score_thr == 1.5
            continue
        np.testing.assert_array_equal(got, want)
    assert demo_utils.multiclass_nms(boxes[:0], scores[:0], 0.45, 0.1,
                                     class_agnostic=False) is None


@pytest.mark.parametrize("p6", [False, True])
def test_demo_postprocess_bit_equal(p6):
    size = (128, 96)
    strides = (8, 16, 32, 64) if p6 else (8, 16, 32)
    n = sum((size[0] // s) * (size[1] // s) for s in strides)
    raw = np.random.RandomState(4).normal(0, 1, (2, n, 85)).astype(
        np.float32)
    got = demo_utils.demo_postprocess(raw.copy(), size, p6)
    want = ref_utils.demo_postprocess(raw.copy(), size, p6)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 4:], raw[..., 4:])


# ---------------------------------------------------------------------------
# Demo against eop_tpu's tools/demo.py
# ---------------------------------------------------------------------------

def jax_demo_module():
    spec = importlib.util.spec_from_file_location(
        "_jax_demo", os.path.join(ROOT, "tools", "demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Two PNGs and a JPEG at test_size, blocks of colour on noise."""
    root = tmp_path_factory.mktemp("demo")
    img_dir = root / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(3)
    for name in ("a.png", "b.png", "c.jpg"):
        img = rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
        img[20:70, 30:100] = rng.randint(0, 256, 3)
        img[80:120, 10:50] = rng.randint(0, 256, 3)
        (write_png if name.endswith(".png") else write_jpeg)(
            str(img_dir / name), img)
    return root, img_dir


def spread_scores(sd):
    """The initial weights with seeded objectness and class heads scaled
    up: scores spread over (0, 1) by anchor instead of sitting at the
    prior, so the threshold and the NMS order meet no near-ties."""
    rng = np.random.RandomState(0)
    for k, v in sd.items():
        if ".obj_preds." in k or ".cls_preds." in k:
            sd[k] = (v * 60 if k.endswith("weight") else torch.as_tensor(
                rng.normal(0.0, 1.5, v.shape), dtype=v.dtype))
    return sd


@pytest.fixture(scope="module")
def jax_demos(images):
    """eop_tpu's Demo for each family on the .pth of its own initial
    weights: {kind: (pth, tools/demo.py's module, its Demo, the Demo's
    infer function, {file: (rows, drawn image)})}."""
    import jax
    import jax.numpy as jnp

    from eop_tpu.exp import get_exp
    from eop_tpu.models import init_model
    from eop_tpu_torch.utils.weights import state_dict_from_jax

    root, img_dir = images
    mod = jax_demo_module()
    out = {}
    for kind, which in EXPS.items():
        args = mod.make_parser().parse_args(
            [*which, "-p", str(img_dir), "--conf", CONF, *TINY])
        exp = get_exp(args.exp_file and os.path.join(ROOT, args.exp_file),
                      args.name)
        exp.merge(args.opts)
        variables = init_model(exp.get_model(), jax.random.PRNGKey(0),
                               jnp.zeros((1, SIZE, SIZE, 3)), on_host=True)
        tree = jax.tree_util.tree_map(np.asarray, dict(variables))
        pth = str(root / f"{kind}.pth")
        torch.save({"model": spread_scores(state_dict_from_jax(tree)),
                    "optimizer": {}, "start_epoch": 0}, pth)
        args.weights = pth
        jdemo = mod.Demo(exp, args)
        infer = jdemo.load([])
        runs = {}
        for f in sorted(os.listdir(img_dir)):
            img = imread(str(img_dir / f))
            rows, r = jdemo.detect(infer, img)
            runs[f] = (np.asarray(rows), jdemo.draw(img.copy(), rows, r))
        out[kind] = (pth, mod, jdemo, infer, runs)
    return out


@pytest.mark.parametrize("kind", ["24p", "bbox"])
def test_demo_matches_eop_tpu(kind, images, jax_demos, tmp_path, capsys):
    root, img_dir = images
    pth, _, _, _, runs = jax_demos[kind]
    got = demo.main([*EXPS[kind], "-w", pth, "-p", str(img_dir), "--conf",
                     CONF, "--device", "cpu", "--save-dir", str(tmp_path),
                     *TINY])
    printed = capsys.readouterr().out
    assert [r["file"] for r in got.results] == ["a.png", "b.png", "c.jpg"]
    width = 29 if kind == "24p" else 7
    for r in got.results:
        want_rows, want_img = runs[r["file"]]
        assert r["rows"].shape == want_rows.shape == (len(want_rows), width)
        assert len(want_rows) > 0
        scale = max(1.0, float(np.abs(want_rows).max()))
        assert np.abs(r["rows"] - want_rows).max() <= 1e-4 * scale
        assert r["ratio"] == 1.0
        assert f"{r['file']}: {len(want_rows)} detections -> {r['path']}" \
            in printed
        written = imread(r["path"])
        assert written.shape == (SIZE, SIZE, 3)
        if r["file"].endswith(".png"):
            np.testing.assert_array_equal(written, want_img)
        # the drawing of the port's own rows, as eop_tpu's Demo.draw
        img = imread(str(img_dir / r["file"]))
        np.testing.assert_array_equal(
            got.draw(img.copy(), r["rows"], r["ratio"]), want_img)
    assert re.search(r"3 images, \d+ detections, [0-9.]+ ms/img", printed)


def test_demo_one_file_and_int8(images, jax_demos, tmp_path, capsys):
    """-p on one file writes that file alone; --int8 calibrates on the
    images and quantizes the convs ops/quant.py counts, and raises for a
    bf16 model."""
    from eop_tpu_torch.exp import get_exp
    from eop_tpu_torch.ops import quant
    from eop_tpu_torch.tools.eval import eval_weights

    root, img_dir = images
    pth = jax_demos["24p"][0]
    one = demo.main([*EXPS["24p"], "-w", pth, "-p", str(img_dir / "c.jpg"),
                     "--device", "cpu", "--save-dir", str(tmp_path / "one"),
                     *TINY])
    assert os.listdir(tmp_path / "one") == ["c.jpg"]
    assert imread(str(tmp_path / "one" / "c.jpg")).shape == (SIZE, SIZE, 3)
    assert len(one.results) == 1
    capsys.readouterr()
    q = demo.main([*EXPS["24p"], "-w", pth, "-p", str(img_dir), "--int8",
                   "--quant-min-channels", "16", "--device", "cpu",
                   "--save-dir", str(tmp_path / "q"), *TINY])
    printed = capsys.readouterr().out
    n = int(re.search(r"int8 PTQ: (\d+) convs on the int8 path",
                      printed).group(1))
    exp = get_exp(os.path.join(ROOT, "load_eval/yolox_24p_eval.py"))
    exp.merge(TINY)
    model = exp.get_model("cpu")
    model.load_state_dict(eval_weights(pth))
    calib = [imread(str(img_dir / f)).astype(np.float32)[None]
             for f in ("a.png", "b.png", "c.jpg")]
    deploy, scales = exp.quantize_for_inference(model, calib, 16)
    assert n == len(quant.quantized_keys(deploy, scales, 16)) > 0
    assert sorted(os.listdir(tmp_path / "q")) == ["a.png", "b.png", "c.jpg"]
    assert all(r["rows"].shape[1] == 29 for r in q.results)
    # int8 of a bf16 model is not ported (ROADMAP queue 1 item 5)
    with pytest.raises(NotImplementedError, match="item 5"):
        demo.main([*EXPS["24p"], "-p", str(img_dir / "a.png"), "--int8",
                   "--device", "cpu", "--save-dir", str(tmp_path / "bf"),
                   *TINY, "compute_dtype", "bfloat16"])


def test_demo_video_matches_eop_tpu(images, jax_demos, tmp_path, capsys,
                                    monkeypatch):
    """A 3-frame video through both run_video: the same frame count out;
    eop_tpu's Demo reuses its compiled function."""
    cv2 = pytest.importorskip("cv2")
    root, img_dir = images
    pth, mod, jdemo, infer, _ = jax_demos["24p"]
    src = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (SIZE, SIZE))
    for f in ("a.png", "b.png", "c.jpg"):
        writer.write(imread(str(img_dir / f)))
    writer.release()
    monkeypatch.setattr(jdemo, "load", lambda calib: infer)
    (tmp_path / "ref").mkdir()
    mod.run_video(jdemo, src, str(tmp_path / "ref"))
    demo.main([*EXPS["24p"], "-w", pth, "-p", src, "--device", "cpu",
               "--save-dir", str(tmp_path / "port"), *TINY])
    printed = capsys.readouterr().out
    assert "3 frames -> " in printed

    def frames(path):
        cap = cv2.VideoCapture(path)
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        return n

    assert frames(str(tmp_path / "port" / "clip.avi")) == frames(
        str(tmp_path / "ref" / "clip.avi")) == 3


def test_demo_without_opencv(images, jax_demos, tmp_path, monkeypatch):
    """With cv2 unimportable: images still read and write; a .webp output
    and a video raise naming OpenCV; a progressive JPEG raises naming the
    file.  None of them skips silently."""
    cv2 = pytest.importorskip("cv2")
    root, img_dir = images
    pth = jax_demos["24p"][0]
    img = imread(str(img_dir / "a.png"))
    webp = tmp_path / "in" / "x.webp"  # PNG content under a .webp name
    webp.parent.mkdir()
    write_png(str(webp), img)
    prog = tmp_path / "p.jpg"
    cv2.imwrite(str(prog), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"\0" * 64)
    monkeypatch.setitem(sys.modules, "cv2", None)
    argv = [*EXPS["24p"], "-w", pth, "--device", "cpu", "--save-dir",
            str(tmp_path / "out"), *TINY]
    d = demo.main(["-p", str(img_dir / "b.png"), *argv])
    assert imread(d.results[0]["path"]).shape == (SIZE, SIZE, 3)
    with pytest.raises(RuntimeError, match=r"x\.webp needs OpenCV"):
        demo.main(["-p", str(webp), *argv])
    with pytest.raises(RuntimeError, match=r"clip\.mp4 needs OpenCV"):
        demo.main(["-p", str(clip), *argv])
    with pytest.raises(RuntimeError, match=r"p\.jpg: decoding .*OpenCV"):
        demo.main(["-p", str(prog), *argv])
