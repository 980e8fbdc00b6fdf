"""The feature-map study's pieces without OpenCV, held to OpenCV and to
``eop_tpu``: ``polygons_to_mask`` / ``fill_poly`` against
``cv2.fillPoly``, ``resize_linear`` / ``resized_at`` against
``cv2.resize``, ``remap`` against ``cv2.remap``, ``vis`` against
``cv2.rectangle`` and ``eop_tpu``'s ``vis``; ``get_img_mask``, both
``sector_distort`` formulations, the activation table and ``coco_ap``
against ``eop_tpu.tools.featuremap`` on identical inputs; ``COCO_ID2IDX``.
"""

import json
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eop_tpu.tools import featuremap as jfm
from eop_tpu_torch.data import coco_api
from eop_tpu_torch.data.augment import remap
from eop_tpu_torch.data.transforms import resize_linear, resized_at
from eop_tpu_torch.tools import featuremap as tfm
from eop_tpu_torch.utils.synth import write_featuremap_fixture
from eop_tpu_torch.utils.visualize import rectangle, vis


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases(kind, n, seed):
    """Seeded integer polygon sets on images of 20..90 px."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        h, w = (int(v) for v in rng.randint(20, 90, 2))
        polys = []
        for _ in range(int(rng.randint(1, 4))):
            k = int(rng.randint(3, 12))
            if kind == "star":  # concave, around a centre inside
                c = rng.uniform(0, [w, h])
                r = rng.uniform(2, min(h, w) / 2, k)
                a = np.sort(rng.uniform(0, 2 * np.pi, k))
                p = np.stack([np.clip(c[0] + r * np.cos(a), 0, w - 1),
                              np.clip(c[1] + r * np.sin(a), 0, h - 1)], 1)
            elif kind == "touching":  # shared edges: a grid of squares
                x0, y0 = rng.randint(0, w // 2), rng.randint(0, h // 2)
                s = int(rng.randint(3, 10))
                j = len(polys)
                p = np.array([[x0 + j * s, y0], [x0 + (j + 1) * s, y0],
                              [x0 + (j + 1) * s, y0 + s], [x0 + j * s,
                                                           y0 + s]])
                p = np.clip(p, 0, [w - 1, h - 1])
            elif kind == "border":  # vertices up to w, h (COCO's range)
                p = np.stack([rng.randint(0, w + 1, k),
                              rng.randint(0, h + 1, k)], 1)
            elif kind == "outside":  # vertices up to 8 px outside
                p = np.stack([rng.randint(-8, w + 9, k),
                              rng.randint(-8, h + 9, k)], 1)
            else:  # "inside": random, self-intersecting
                p = rng.uniform(0, [w, h], (k, 2))
            polys.append(np.round(p).astype(np.int32))
        yield h, w, polys


# outside: where a segment leaves the image, OpenCV 5.0 fills the image's
# edge pixels along it by rules fill_poly does not reproduce: 195 pixels in
# 14 of the 200 sets, all on the border rows and columns (pinned there)
OUTSIDE_DIFF = 195


@pytest.mark.parametrize("kind,differing", [
    ("inside", 0), ("star", 0), ("touching", 0), ("border", 0),
    ("outside", OUTSIDE_DIFF)])
def test_fill_poly_equals_cv2(kind, differing):
    """``fill_poly`` against ``cv2.fillPoly`` on 200 seeded sets of one to
    three polygons each (even-odd across them): bit-equal, vertices on the
    far border (x = w, y = h: COCO's range) included; the pinned count of
    pixels where vertices lie further outside."""
    diff = 0
    for h, w, polys in _cases(kind, 200, seed=len(kind)):
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, polys, 1)
        got = coco_api.fill_poly(np.zeros((h, w), np.uint8),
                                 [p.astype(np.int64) for p in polys], 1)
        diff += int((got != want).sum())
        assert (got != want)[1:-1, 1:-1].sum() == 0
    assert diff == differing


def test_polygons_to_mask_without_cv2(monkeypatch):
    """COCO float polygons rounded then filled, the same mask with cv2
    unimportable as cv2.fillPoly draws; annToMask through it."""
    polys = [[10.4, 5.6, 40.2, 8.1, 35.5, 30.7, 12.0, 28.2, 22.5, 15.5],
             [50.0, 40.0, 60.0, 40.0, 55.0, 55.0]]
    want = np.zeros((64, 80), np.uint8)
    cv2.fillPoly(want, [np.asarray(p).reshape(-1, 2).round().astype(np.int32)
                        for p in polys], 1)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(coco_api.polygons_to_mask(polys, 64, 80),
                                  want)
    coco = coco_api.COCO()
    coco.dataset = {"images": [{"id": 1, "height": 64, "width": 80}],
                    "annotations": [{"id": 1, "image_id": 1, "bbox": [0] * 4,
                                     "category_id": 1, "segmentation": polys,
                                     "area": 1.0, "iscrowd": 0}],
                    "categories": [{"id": 1, "name": "a"}]}
    coco.createIndex()
    np.testing.assert_array_equal(coco.annToMask(coco.anns[1]), want)


@pytest.mark.parametrize("src,dst,channels", [
    ((48, 64), (30, 1320), 3), ((240, 320), (700, 13200), 3),
    ((37, 53), (64, 40), 3), ((100, 80), (33, 27), 1),
    ((240, 320), (120, 160), 3), ((5, 7), (1, 1), 3), ((1, 9), (4, 3), 3)])
def test_resize_linear_equals_cv2(src, dst, channels):
    """Up, down, by 2, to and from one pixel: bit-equal to cv2.resize; the
    pixels ``resized_at`` computes alone equal the whole image's."""
    rng = np.random.RandomState(sum(src + dst))
    img = rng.randint(0, 256, (*src, channels)).astype(np.uint8)
    want = cv2.resize(img, dst[::-1]).reshape(*dst, channels)
    got = resize_linear(img, dst)
    np.testing.assert_array_equal(got, want)
    ys = rng.randint(0, dst[0], 500)
    xs = rng.randint(0, dst[1], 500)
    np.testing.assert_array_equal(resized_at(img, dst, ys, xs), want[ys, xs])


def test_remap_equals_cv2():
    """Bilinear with a constant border of 114 and nearest with 0, maps
    inside, across the border and far outside: bit-equal to cv2.remap."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (50, 70, 3)).astype(np.uint8)
    mx = rng.uniform(-3, 73, (40, 60)).astype(np.float32)
    my = rng.uniform(-3, 53, (40, 60)).astype(np.float32)
    mx[::7] = -10
    want = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_CONSTANT,
                     borderValue=(114, 114, 114))
    np.testing.assert_array_equal(remap(img, mx, my, 114), want)
    want = cv2.remap(img, mx, my, cv2.INTER_NEAREST,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    np.testing.assert_array_equal(remap(img, mx, my, 0, nearest=True), want)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    path = write_featuremap_fixture(
        str(tmp_path_factory.mktemp("fm_fixture")), (240, 320))
    return tfm.get_img_info(path), jfm.get_img_info(path)


def test_get_img_mask_equals_eop_tpu(fixture):
    """The fixture read the same, and every offset's canvas, boxes and
    shifted mask bit-equal."""
    (tc, tt, timg, h, w), (jc, jt, jimg, jh, jw) = fixture
    np.testing.assert_array_equal(timg, jimg)
    assert (h, w) == (jh, jw) == (240, 320) and len(tt) == 2
    for offset in range(-100, 150, 50):
        got = tfm.get_img_mask(offset, timg, h, w, tt, tc, frame=64)
        want = jfm.get_img_mask(offset, jimg, h, w, jt, jc, frame=64)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g, wnt)


@pytest.mark.parametrize("reference_parity", [False, True])
@pytest.mark.parametrize("theta", [30, 75])
def test_sector_distort_equals_eop_tpu(fixture, theta, reference_parity):
    """Both formulations, two angles, offsets -50 and 100: the warped
    image and the distorted GT box bit-equal to eop_tpu's (OpenCV's
    resize and remap reproduced)."""
    (tc, tt, timg, h, w), _ = fixture
    for offset in (-50, 100):
        canvas, _, _, mask = tfm.get_img_mask(offset, timg, h, w, tt, tc)
        got = tfm.ImageDistortion().sector_distort(
            canvas, mask, theta, reference_parity=reference_parity)
        want = jfm.ImageDistortion().sector_distort(
            canvas, mask, theta, reference_parity=reference_parity)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and len(got[1]) == 4


def test_activation_table_and_figure(tmp_path):
    """The same FPN maps, predictions and GT boxes (one partly outside a
    map): the per-GT activations within 1e-5 relative of eop_tpu's, the
    same table key; the figure a 2 x 3 PNG of 320 px cells."""
    from eop_tpu_torch.data.image_io import imread

    rng = np.random.RandomState(4)
    fpn = [rng.randn(1, s, s, 16).astype(np.float32) for s in (8, 4, 2)]
    rows = np.array([[5.0, 6.0, 40.0, 50.0, 0.9, 0.8, 1.0],
                     [30.0, 2.0, 60.0, 20.0, 0.5, 0.5, 2.0]])
    gt = np.array([[0.1, 0.2, 0.6, 0.7], [0.5, -0.2, 0.9, 0.4]])
    want_table, got_table = {}, {}
    want = jfm.create_2d_feature_map(fpn, rows, gt, "d/offset_-50_none.png",
                                     want_table, frame=64)
    path = str(tmp_path / "fm.png")
    got = tfm.create_2d_feature_map(fpn, rows, gt, "d/offset_-50_none.png",
                                    got_table, save_path=path, frame=64)
    np.testing.assert_allclose(got, want, rtol=1e-5, equal_nan=True)
    assert list(got_table) == list(want_table) == ["offset_-50_none"]
    assert len(got) == 6 and np.isfinite(got).sum() >= 3
    img = imread(path)
    assert img.shape == (2 * 320 + 8, 3 * 320 + 16, 3)
    assert (img[320:328] == 255).all()


def test_vis_boxes_equal_cv2_and_eop_tpu(monkeypatch):
    """2-px boxes against cv2.rectangle on 300 seeded boxes (clipped,
    reversed, degenerate); with cv2, vis equals eop_tpu's (boxes, label bars,
    text); without it, the boxes alone."""
    from eop_tpu.utils.visualize import vis as jvis

    rng = np.random.RandomState(5)
    for _ in range(300):
        h, w = rng.randint(10, 60, 2)
        got, want = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3),
                                                            np.uint8)
        p0 = tuple(int(v) for v in rng.randint(-10, 70, 2))
        p1 = tuple(int(v) for v in rng.randint(-10, 70, 2))
        cv2.rectangle(want, p0, p1, (1, 2, 3), 2)
        rectangle(got, p0, p1, (1, 2, 3))
        np.testing.assert_array_equal(got, want)
    img = rng.randint(0, 255, (120, 160, 3)).astype(np.uint8)
    boxes = rng.uniform(-20, 170, (12, 4))
    scores, cls = rng.uniform(0, 1, 12), rng.randint(0, 80, 12)
    np.testing.assert_array_equal(vis(img.copy(), boxes, scores, cls, 0.3),
                                  jvis(img.copy(), boxes, scores, cls, 0.3))
    monkeypatch.setitem(sys.modules, "cv2", None)
    plain = vis(img.copy(), boxes, scores, cls, 0.3)
    want = img.copy()
    for b, s, c in zip(boxes, scores, cls):
        if s >= 0.3:
            rgb = (vis.__globals__["_COLORS"][c] * 255).astype(np.uint8)
            cv2_free = [int(v) for v in b]
            rectangle(want, cv2_free[:2], cv2_free[2:], rgb.tolist())
    np.testing.assert_array_equal(plain, want)


def test_coco_ap_equals_eop_tpu(tmp_path):
    """One sweep's gt / dt jsons: the 12 stats equal eop_tpu's; no
    detections gives zeros in both."""
    gt = {"images": [{"id": i, "height": 100, "width": 120}
                     for i in (-50, 0, 50)],
          "annotations": [{"id": k + 1, "image_id": i, "category_id": 1,
                           "bbox": [10.0 + k, 20.0, 30.0, 40.0],
                           "area": 1200.0, "iscrowd": 0}
                          for k, i in enumerate((-50, 0, 50))],
          "categories": [{"id": 1, "name": "1"}, {"id": 3, "name": "3"}]}
    dt = [{"image_id": i, "category_id": 1, "score": s,
           "bbox": [10.0 + d, 22.0, 30.0 - d, 37.0]}
          for i, s, d in ((-50, 0.9, 1.0), (0, 0.4, 8.0), (50, 0.7, 0.0),
                          (50, 0.2, 30.0))]
    for name, obj in (("gt.json", gt), ("dt.json", dt), ("none.json", [])):
        (tmp_path / name).write_text(json.dumps(obj))
    g, d, e = (str(tmp_path / n) for n in ("gt.json", "dt.json",
                                            "none.json"))
    np.testing.assert_allclose(tfm.coco_ap(g, d), jfm.coco_ap(g, d),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tfm.coco_ap(g, e), np.zeros(12))


def test_coco_id2idx_equals_eop_tpu():
    from eop_tpu.data.labels24p import COCO_ID2IDX as want
    from eop_tpu_torch.data.labels24p import COCO_ID2IDX

    assert COCO_ID2IDX == want and len(want) == 80
