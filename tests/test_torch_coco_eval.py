"""The port's COCO evaluation on the CPU: the C++ matcher (built for the host
by ``_build``) against its plain version, and ``COCOeval`` and
``COCO.loadRes`` against the JAX package's.

Tolerances: matcher outputs exactly equal; ``stats`` within 1e-12 (both are
float64 numpy over the same matches)."""

import numpy as np
import pytest

from eop_tpu.data.coco_api import COCO as JCOCO
from eop_tpu.eval.coco_eval import COCOeval as JCOCOeval
from eop_tpu_torch import _build
from eop_tpu_torch.data.coco_api import COCO
from eop_tpu_torch.eval import fast_cocoeval
from eop_tpu_torch.eval.coco_eval import COCOeval
from eop_tpu_torch.eval.fast_cocoeval import match_image, match_image_py

THRS = np.linspace(0.5, 0.95, 10)


@pytest.mark.parametrize("seed", range(6))
def test_native_matcher_equals_plain(seed):
    """Random cells with crowd ground truths (many detections may match
    one), ignored ones sorted last, out-of-range detections, and the empty
    sides."""
    rng = np.random.RandomState(seed)
    for d, g in ((7, 5), (12, 3), (3, 9), (0, 4), (5, 0), (1, 1)):
        iou = rng.uniform(0.3, 1.0, (d, g)) * (rng.rand(d, g) < 0.7)
        ignore = np.sort(rng.rand(g) < 0.3).astype(np.int32)  # ignores last
        crowd = (rng.rand(g) < 0.3).astype(np.int32)
        oor = (rng.rand(d) < 0.3).astype(np.int32)
        calls = match_image.native_calls
        got = match_image(THRS, iou, ignore, crowd, oor)
        want = match_image_py(THRS, iou, ignore, crowd, oor)
        assert match_image.native_calls == calls + 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_native_matcher_is_a_host_build():
    assert _build.is_host("cocoeval") and not _build.is_host("phase_conv")
    lib = fast_cocoeval._lib()
    assert _build._target("cocoeval").exists()
    assert lib is _build.load("cocoeval")
    with pytest.raises(ValueError, match="iou"):
        match_image(THRS, np.zeros((2, 3)), np.zeros(2), np.zeros(2),
                    np.zeros(2))


def random_coco(seed, n_img=6, n_cat=3):
    """GT over all three area ranges (boxes 5-200 px), some crowd; detections
    jittered from the GTs plus false ones, up to 130 an image (over the
    largest maxDets), with a few tied scores."""
    rng = np.random.RandomState(seed)
    images = [{"id": i, "width": 640, "height": 480}
              for i in range(1, n_img + 1)]
    anns, dets = [], []
    for img in images:
        for _ in range(rng.randint(0, 12)):
            w, h = np.exp(rng.uniform(np.log(5), np.log(200), 2))
            x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            cat = int(rng.randint(n_cat))
            anns.append({"id": len(anns) + 1, "image_id": img["id"],
                         "category_id": cat, "bbox": [x, y, w, h],
                         "area": w * h, "iscrowd": int(rng.rand() < 0.1)})
            for _ in range(rng.randint(0, 4)):
                j = rng.normal(0, 0.1 * min(w, h), 4)
                dets.append({"image_id": img["id"], "category_id": cat,
                             "bbox": [x + j[0], y + j[1], max(w + j[2], 1.0),
                                      max(h + j[3], 1.0)],
                             "score": float(rng.choice([0.5, rng.rand()]))})
        for _ in range(rng.randint(0, 130 if img["id"] == 1 else 20)):
            w, h = rng.uniform(4, 150, 2)
            dets.append({"image_id": img["id"],
                         "category_id": int(rng.randint(n_cat)),
                         "bbox": [float(rng.uniform(0, 500)),
                                  float(rng.uniform(0, 350)), w, h],
                         "score": float(rng.rand())})
    cats = [{"id": c, "name": str(c)} for c in range(n_cat)]
    return {"images": images, "annotations": anns, "categories": cats}, dets


def _index(cls, dataset):
    gt = cls()
    gt.dataset = dataset
    gt.createIndex()
    return gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cocoeval_stats_match_jax(seed, capsys):
    dataset, dets = random_coco(seed)
    stats = []
    for coco_cls, eval_cls in ((COCO, COCOeval), (JCOCO, JCOCOeval)):
        gt = _index(coco_cls, dataset)
        e = eval_cls(gt, gt.loadRes(dets), "bbox")
        e.evaluate()
        e.accumulate()
        e.summarize()
        stats.append((np.asarray(e.stats), e.eval["precision"],
                      e.eval["recall"]))
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 24 and printed[:12] == printed[12:]
    (s, p, r), (js, jp, jr) = stats
    assert s.shape == (12,) and 0 < s[1] < 1
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-12)
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-12)


def test_load_res_matches_jax():
    dataset, dets = random_coco(4)
    res = _index(COCO, dataset).loadRes(dets)
    j_res = _index(JCOCO, dataset).loadRes(dets)
    assert res.dataset == j_res.dataset
    assert res.getImgIds() == j_res.getImgIds()
    assert res.getCatIds() == j_res.getCatIds()
    for img in res.getImgIds():
        ids = res.getAnnIds(imgIds=[img], catIds=[1])
        assert ids == j_res.getAnnIds(imgIds=[img], catIds=[1])
        assert res.loadAnns(ids) == j_res.loadAnns(ids)
    assert res.loadImgs([1, 2]) == j_res.loadImgs([1, 2])
    assert "segmentation" not in dets[0]       # the input stays as it was
    empty = _index(COCO, dataset).loadRes([])
    assert empty.dataset["annotations"] == []
    assert empty.getCatIds() == [0, 1, 2]


def test_segm_stats_match_jax():
    """Mask AP over RLE segmentations (no polygon rendering, so no OpenCV)."""
    from eop_tpu.data.coco_api import mask_to_rle as j_mask_to_rle
    from eop_tpu_torch.data.coco_api import mask_to_rle

    rng = np.random.RandomState(5)
    h, w = 40, 50
    images = [{"id": i, "width": w, "height": h} for i in (1, 2, 3)]
    anns, dets = [], []
    for img in images:
        for _ in range(3):
            m = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h - 10), rng.randint(0, w - 10)
            m[y:y + rng.randint(4, 10), x:x + rng.randint(4, 10)] = 1
            rle = mask_to_rle(m)
            assert rle == j_mask_to_rle(m)
            anns.append({"id": len(anns) + 1, "image_id": img["id"],
                         "category_id": 0, "segmentation": rle,
                         "area": float(m.sum()), "iscrowd": 0,
                         "bbox": [float(x), float(y), 1.0, 1.0]})
            d = np.roll(m, rng.randint(-2, 3), axis=1)
            dets.append({"image_id": img["id"], "category_id": 0,
                         "segmentation": mask_to_rle(d),
                         "score": float(rng.rand())})
    dataset = {"images": images, "annotations": anns,
               "categories": [{"id": 0, "name": "0"}]}
    stats = []
    for coco_cls, eval_cls in ((COCO, COCOeval), (JCOCO, JCOCOeval)):
        gt = _index(coco_cls, dataset)
        e = eval_cls(gt, gt.loadRes(dets), "segm")
        e.evaluate()
        e.accumulate()
        e.summarize()
        stats.append(np.asarray(e.stats))
    assert 0 < stats[1][1] <= 1
    np.testing.assert_allclose(stats[0], stats[1], rtol=0, atol=1e-12)
