"""The 24p drawing tools against ``eop_tpu`` and OpenCV on the CPU:

* ``python -m eop_tpu_torch.tools.show_24p --device cpu`` against
  ``tools/show_24p.py``'s ``Evaluator`` (loaded by path) on 2 seeded PNGs at
  128 px, both reading one reference-form ``.pth`` made from the JAX
  model's own ``PRNGKey(0)`` weights (``state_dict_from_jax``): rows within
  1e-4, the decoded images equal; also with ``--reference-parity``;
* ``vis_24p`` and ``Trainer24P.render_train_sample`` bit-equal to
  ``eop_tpu``'s on seeded rows (polygons past the image's edges included);
  with cv2 made unimportable the port's lines and circles are bit-equal to
  ``cv2.polylines`` / ``cv2.circle`` (the labels are not drawn);
* ``polylines`` (closed, thickness 2, 3, 4) and ``circle`` (1, filled)
  against OpenCV on seeded shapes, ends inside and outside the image.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eop_tpu_torch.data.image_io import imread
from eop_tpu_torch.tools import show_24p
from eop_tpu_torch.train.trainer_24p import Trainer24P
from eop_tpu_torch.utils import visualize
from eop_tpu_torch.utils.synth import write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["depth", "0.33", "width", "0.25", "num_classes", "80",
        "test_size", "(128, 128)"]
CONF = "0.3"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_show_module():
    spec = importlib.util.spec_from_file_location(
        "_jax_show_24p", os.path.join(ROOT, "tools", "show_24p.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("show24p")
    img_dir = root / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(3)
    for name, hw in (("a.png", (96, 128)), ("b.png", (128, 100))):
        img = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
        img[20:60, 30:90] = rng.randint(0, 256, 3)
        write_png(str(img_dir / name), img)
    return root, str(img_dir)


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
def jax_runs(images):
    """eop_tpu's show_24p at 128 px, plain and with --reference-parity, on
    the reference-form .pth of its own initial weights: {parity: (rows by
    file, output dir)}."""
    import jax

    from eop_tpu.exp import get_exp
    from eop_tpu_torch.utils.weights import state_dict_from_jax

    root, img_dir = images
    mod = jax_show_module()
    out = {}
    pth = str(root / "ref.pth")
    for parity in (False, True):
        argv = ["-f", "load_eval/yolox_24p_eval.py", "-p", img_dir,
                "--conf", CONF] + (["--reference-parity"] if parity else []) \
            + [*TINY, "output_dir", str(root / f"jax_{parity}")]
        args = mod.make_parser().parse_args(argv)
        exp = get_exp(os.path.join(ROOT, args.exp_file))
        exp.merge(args.opts)
        ev = mod.Evaluator(exp, args)
        if not parity:
            _, variables = ev.load_model()
            tree = jax.tree_util.tree_map(np.asarray, dict(variables))
            torch.save({"model": spread_scores(state_dict_from_jax(tree)),
                        "optimizer": {}, "start_epoch": 0}, pth)
        args.weights = pth
        rows = {}
        infer = exp.get_infer_fn

        def spy(model, variables):
            fn = infer(model, variables)

            def call(imgs):
                dets = fn(imgs)
                d = jax.device_get(dets)
                rows[len(rows)] = d.rows[0][d.valid[0].astype(bool)]
                return dets

            return call

        exp.get_infer_fn = spy
        save_dir = ev.eval()
        files = sorted(os.listdir(img_dir))
        out[parity] = ({f: rows[i] for i, f in enumerate(files)}, save_dir)
    return pth, out


@pytest.mark.parametrize("parity", [False, True], ids=["plain", "parity"])
def test_show_24p_matches_eop_tpu(images, jax_runs, parity, tmp_path,
                                  capsys):
    root, img_dir = images
    pth, runs = jax_runs
    want_rows, want_dir = runs[parity]
    argv = ["-w", pth, "-p", img_dir, "--conf", CONF, "--device", "cpu"] + (
        ["--reference-parity"] if parity else []) + [
        *TINY, "output_dir", str(tmp_path)]
    ev = show_24p.main(argv)
    printed = capsys.readouterr().out
    assert [r["file"] for r in ev.results] == ["a.png", "b.png"]
    for r in ev.results:
        want = want_rows[r["file"]]
        assert r["rows"].shape == want.shape and len(want) > 0
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(r["rows"] - want).max() <= 1e-4 * scale
        assert f"{r['file']}: {len(want)} detections -> {r['path']}" \
            in printed
        assert os.path.dirname(r["path"]).startswith(
            os.path.join(str(tmp_path), "yolox_24p"))
        got_px, want_px = imread(r["path"]), cv2.imread(
            os.path.join(want_dir, r["file"]))
        assert np.array_equal(got_px, want_px)
        # something was drawn
        assert not np.array_equal(got_px, imread(os.path.join(
            img_dir, r["file"])))


def seeded_rows(n, hw, seed):
    """Detection rows ``[x, y, r1..r24, obj, cls_conf, cls]`` in letterbox
    coordinates: centres on and off the image, radii up to past its
    edges, scores on both sides of 0.3."""
    rng = np.random.RandomState(seed)
    h, w = hw
    rows = np.zeros((n, 29), np.float32)
    rows[:, 0] = rng.uniform(-0.2 * w, 1.2 * w, n)
    rows[:, 1] = rng.uniform(-0.2 * h, 1.2 * h, n)
    rows[:, 2:26] = rng.uniform(0.5, 0.6 * max(h, w), (n, 24))
    rows[:, 26] = rng.uniform(0.3, 1.0, n)
    rows[:, 27] = rng.uniform(0.3, 1.0, n)
    rows[:, 28] = rng.randint(0, 80, n)
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vis_24p_equals_eop_tpu(seed):
    from eop_tpu.utils.visualize import vis_24p as jax_vis_24p

    img = np.random.RandomState(seed).randint(0, 256, (90, 140, 3),
                                              np.uint8)
    rows = seeded_rows(12, (90, 140), seed)
    for ratio in (1.0, 0.7):
        want = jax_vis_24p(img.copy(), rows, ratio=ratio, conf=0.3)
        got = visualize.vis_24p(img.copy(), rows, ratio=ratio, conf=0.3)
        assert np.array_equal(got, want)


def cv2_shapes_24p(img, rows, ratio, conf):
    """vis_24p's polygons and centres drawn by OpenCV, without labels."""
    from eop_tpu_torch.ops.polygon import COS_ANGLES, SIN_ANGLES

    for det in rows:
        if float(det[26] * det[27]) < conf:
            continue
        cls_id = int(det[28])
        cx, cy = det[0] / ratio, det[1] / ratio
        radii = np.asarray(det[2:26]) / ratio
        pts = np.stack([(cx + radii * COS_ANGLES).astype(np.int32),
                        (cy + radii * SIN_ANGLES).astype(np.int32)], 1)
        color = (visualize._COLORS[cls_id % 80] * 255).astype(
            np.uint8).tolist()
        cv2.polylines(img, [pts.reshape(-1, 1, 2)], True, color, 2)
        cv2.circle(img, (int(cx), int(cy)), 3, color, -1)
    return img


@pytest.mark.parametrize("seed", [3, 4])
def test_vis_24p_without_cv2_draws_opencvs_shapes(seed, monkeypatch):
    img = np.random.RandomState(seed).randint(0, 256, (90, 140, 3),
                                              np.uint8)
    rows = seeded_rows(12, (90, 140), seed)
    want = cv2_shapes_24p(img.copy(), rows, 0.8, 0.3)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(visualize, "_warned", [True])
    got = visualize.vis_24p(img.copy(), rows, ratio=0.8, conf=0.3)
    assert np.array_equal(got, want)


def sample_rows(seed):
    """A training image's label rows (some zero) and detection rows."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((6, 51))
    for i in range(4):
        cx, cy = rng.uniform(10, 150), rng.uniform(10, 110)
        r = rng.uniform(3, 60, 24)
        a = np.arange(24) * np.pi / 12
        gt[i, 0] = rng.randint(3)
        gt[i, 1:3] = cx, cy
        gt[i, 3::2] = cx + r * np.cos(a)
        gt[i, 4::2] = cy + r * np.sin(a)
    pred = seeded_rows(5, (120, 160), seed)
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_render_train_sample_equals_eop_tpu(seed, ext, tmp_path,
                                            monkeypatch):
    """The drawn images equal before encoding (the two JPEG encoders
    differ); a PNG decodes to them."""
    from eop_tpu.train.trainer_24p import Trainer24P as JaxTrainer24P
    from eop_tpu_torch.utils import synth

    img = np.random.RandomState(seed).randint(0, 256, (120, 160, 3),
                                              np.uint8)
    gt, pred = sample_rows(seed)
    drawn = {}
    imwrite, write_image = cv2.imwrite, synth.write_image

    def jax_write(path, out):
        drawn["jax"] = out.copy()
        return imwrite(path, out)

    def port_write(path, out):
        drawn["port"] = out.copy()
        write_image(path, out)

    monkeypatch.setattr(cv2, "imwrite", jax_write)
    monkeypatch.setattr(synth, "write_image", port_write)
    JaxTrainer24P.render_train_sample(None, img, pred, gt,
                                      str(tmp_path / f"jax{ext}"))
    got = Trainer24P.render_train_sample(None, img, pred, gt,
                                         str(tmp_path / f"port{ext}"))
    assert np.array_equal(drawn["port"], drawn["jax"])
    assert not np.array_equal(drawn["port"], img)
    decoded = imread(got)
    assert decoded.shape == img.shape
    if ext == ".png":
        assert np.array_equal(decoded, drawn["jax"])


@pytest.mark.parametrize("seed", [2, 3])
def test_render_train_sample_without_cv2_draws_opencvs_circles(
        seed, tmp_path, monkeypatch):
    from eop_tpu_torch.ops.polygon import radii_from_points

    img = np.random.RandomState(seed).randint(0, 256, (120, 160, 3),
                                              np.uint8)
    gt, pred = sample_rows(seed)
    want = img.copy()
    for row in gt:
        if row.sum():
            r = radii_from_points(torch.as_tensor(row[None, 1:],
                                                  dtype=torch.float32))
            cv2.circle(want, (int(row[1]), int(row[2])),
                       int(r.numpy()[0].mean()), (0, 255, 0), 1)
    for row in pred:
        cv2.circle(want, (int(row[0]), int(row[1])),
                   int(np.mean(row[2:26])), (0, 0, 255), 1)
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = Trainer24P.render_train_sample(None, img, pred, gt,
                                         str(tmp_path / "s.png"))
    assert np.array_equal(imread(out), want)


def random_polyline(rng, h, w, span):
    k = int(rng.randint(1, 8))
    lo = [int(-v * (span - 1) / 2) - 2 for v in (w, h)]
    hi = [int(v * (span + 1) / 2) + 2 for v in (w, h)]
    return np.stack([rng.randint(lo[0], hi[0], k),
                     rng.randint(lo[1], hi[1], k)], 1).astype(np.int32)


@pytest.mark.parametrize("thickness", [2, 3, 4])
def test_polylines_match_opencv(thickness):
    rng = np.random.RandomState(thickness)
    for i in range(300):
        h, w = (int(v) for v in rng.randint(5, 60, 2))
        pts = random_polyline(rng, h, w, (1.0, 3.0, 40.0)[i % 3])
        want = np.zeros((h, w, 3), np.uint8)
        cv2.polylines(want, [pts.reshape(-1, 1, 2)], True, (9, 200, 31),
                      thickness)
        got = visualize.polylines(np.zeros((h, w, 3), np.uint8), pts,
                                  (9, 200, 31), thickness)
        assert np.array_equal(got, want), (h, w, pts.tolist())
    with pytest.raises(ValueError):
        visualize.polylines(np.zeros((4, 4, 3), np.uint8), pts, 0, 1)


@pytest.mark.parametrize("thickness", [1, -1])
def test_circle_matches_opencv(thickness):
    rng = np.random.RandomState(10 + thickness)
    for _ in range(300):
        h, w = (int(v) for v in rng.randint(5, 60, 2))
        c = (int(rng.randint(-8, w + 8)), int(rng.randint(-8, h + 8)))
        r = int(rng.randint(0, 40))
        want = np.zeros((h, w, 3), np.uint8)
        cv2.circle(want, c, r, (1, 2, 3), thickness)
        got = visualize.circle(np.zeros((h, w, 3), np.uint8), c, r,
                               (1, 2, 3), thickness)
        assert np.array_equal(got, want), (h, w, c, r)
    with pytest.raises(ValueError):
        visualize.circle(np.zeros((4, 4, 3), np.uint8), (1, 1), -1, 0)
