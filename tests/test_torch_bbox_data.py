"""The bbox family's data pipeline and evaluator in the port against
``eop_tpu``'s, without OpenCV in the port: HSV and warp against ``cv2``,
augmentations, the mosaic item, COCO records and COCO AP against
``eop_tpu`` on the same seeded data."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eop_tpu.data import augment as jaug  # noqa: E402
from eop_tpu.data.coco_dataset import COCODataset as JCOCODataset  # noqa: E402
from eop_tpu.data.mosaic import MosaicDetection as JMosaic  # noqa: E402
from eop_tpu.eval.coco_evaluator import COCOEvaluator as JEvaluator  # noqa: E402
from eop_tpu_torch.data import augment as aug  # noqa: E402
from eop_tpu_torch.data import cached_dataset, mosaic  # noqa: E402
from eop_tpu_torch.data.coco_dataset import COCODataset  # noqa: E402
from eop_tpu_torch.data.mosaic import MosaicDetection  # noqa: E402
from eop_tpu_torch.eval.coco_evaluator import COCOEvaluator  # noqa: E402
from eop_tpu_torch.eval.postprocess import Detections  # noqa: E402
from eop_tpu_torch.exp import Exp  # noqa: E402
from eop_tpu_torch.utils.synth import LabelOracle, write_coco_dataset  # noqa: E402

SIZE = (64, 64)  # the datasets' img_size and the mosaic's input_dim


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """8 train and 4 val seeded 96x128 JPEG images, 3 classes."""
    root = str(tmp_path_factory.mktemp("coco"))
    return write_coco_dataset(root, 8, 4, (96, 128), num_classes=3, seed=1)


@pytest.mark.parametrize("direction", ["bgr2hsv", "hsv2bgr"])
def test_hsv_conversions_equal_cv2(direction):
    """A quarter of all 2**24 byte triples, 4096 pixels a row (a multiple of
    cv2's vector step): equal to cv2.cvtColor (hue values past 179 too)."""
    v = np.arange(256)
    a, b, c = np.meshgrid(v, v, v[::4], indexing="ij")
    img = np.stack([a, b, c], -1).reshape(-1, 4096, 3).astype(np.uint8)
    ours, code = ((aug.bgr_to_hsv, cv2.COLOR_BGR2HSV)
                  if direction == "bgr2hsv" else
                  (aug.hsv_to_bgr, cv2.COLOR_HSV2BGR))
    np.testing.assert_array_equal(ours(img), cv2.cvtColor(img, code))


def test_augment_hsv_bit_equal_eop_tpu():
    """Eight draws from one seeded generator each, on a 48x128 image: the
    same bytes (including the draws that leave the image untouched)."""
    img = np.random.RandomState(0).randint(0, 256, (48, 128, 3)).astype(
        np.uint8)
    mine, theirs = img.copy(), img.copy()
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(8):
        aug.augment_hsv(mine, r1)
        jaug.augment_hsv(theirs, r2)
        np.testing.assert_array_equal(mine, theirs)
    assert not np.array_equal(mine, img)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_affine_equal_eop_tpu(seed):
    """The mosaic's warp (2x canvas -> target, border 114, large scale
    range): image bytes and boxes equal."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    boxes = np.array([[10, 20, 120, 140, 1], [100, 60, 250, 200, 2.0]])
    kw = dict(target_size=(128, 128), degrees=10.0, translate=0.1,
              scales=(0.1, 2), shear=2.0)
    got_img, got_boxes = aug.random_affine(
        img, boxes.copy(), rng=np.random.default_rng(seed), **kw)
    want_img, want_boxes = jaug.random_affine(
        img, boxes.copy(), rng=np.random.default_rng(seed), **kw)
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_array_equal(got_boxes, want_boxes)
    assert (got_img == 114).any() and (got_img != 114).any()


def _mosaic_items(coco_dir, seeds):
    port = COCODataset(coco_dir, img_size=SIZE)
    ref = JCOCODataset(coco_dir, img_size=SIZE)
    for seed in seeds:
        items = []
        for cls, ds, tt in ((MosaicDetection, port, aug.TrainTransform),
                            (JMosaic, ref, jaug.TrainTransform)):
            m = cls(ds, SIZE, preproc=tt(max_labels=120), mosaic_scale=(0.1, 2))
            m.reseed(seed)
            items.append(m[(True, seed % len(ds))])
        yield items


@pytest.mark.parametrize("resize", ["cv2", "resize_host"])
def test_mosaic_item_with_mixup(coco_dir, resize, monkeypatch):
    """Mosaic + affine + mixup + HSV + flip, six seeds: the label rows are
    bit-equal.  With cv2's resize swapped in, the image is bit-equal too:
    every other stage is.  With the port's resize (one level of cv2's on
    the fit-resized images and the mixup donor), the HSV round trip turns
    that level into up to 10 on 4.6 % of the pixels (measured): held to 16
    levels and 8 %."""
    if resize == "cv2":
        def cv2_resize(img, hw):
            return cv2.resize(img, (hw[1], hw[0]),
                              interpolation=cv2.INTER_LINEAR)

        for module in (aug, cached_dataset, mosaic):
            monkeypatch.setattr(module, "resize_host", cv2_resize)
    worst, share = 0.0, 0.0
    for (img, rows, _, _), (jimg, jrows, _, _) in _mosaic_items(
            coco_dir, range(6)):
        np.testing.assert_array_equal(rows, jrows)
        assert rows.shape == (120, 5) and (rows.sum(1) > 0).sum() >= 2
        d = np.abs(img - jimg)
        worst, share = max(worst, d.max()), max(share, (d > 1).mean())
    if resize == "cv2":
        assert worst == 0
    else:
        assert worst <= 16 and share <= 0.08, (worst, share)


def test_coco_dataset_records_equal_eop_tpu(coco_dir):
    """Ids, classes, cleaned and pre-scaled annotation records equal; the
    images within one level (the resize), also through the memmap cache."""
    port = COCODataset(coco_dir, img_size=SIZE, cache=True)
    ref = JCOCODataset(coco_dir, img_size=SIZE)
    assert port.ids == ref.ids and port.class_ids == ref.class_ids
    assert port._classes == ref._classes
    for (rows, hw, rhw, name), (jrows, jhw, jrhw, jname) in zip(
            port.annotations, ref.annotations):
        np.testing.assert_array_equal(rows, jrows)
        assert (hw, rhw, name) == (jhw, jrhw, jname)
    for i in range(len(port)):
        img, rows, hw, sid = port.pull_item(i)
        jimg, jrows, jhw, jsid = ref.pull_item(i)
        assert np.abs(img.astype(int) - jimg).max() <= 1
        np.testing.assert_array_equal(rows, jrows)
        assert hw == jhw and sid == jsid
    assert port.imgs is not None  # served from the memmap


def test_coco_evaluator_ap_and_tables_equal_eop_tpu(coco_dir):
    """The same detection rows through both evaluators' conversion and
    COCOeval: the same result dicts, AP statistics and per-class AP / AR
    tables (the port prints tabulate's pipe format itself)."""
    ds = COCODataset(coco_dir, name="val2017", json_file="instances_val2017.json",
                     img_size=SIZE)
    loader = torch.utils.data.DataLoader(ds, batch_size=4)
    rng = np.random.RandomState(3)
    rows = np.zeros((4, 300, 7), np.float32)
    valid = np.zeros((4, 300), bool)
    for b in range(4):
        rec = ds.load_anno(b)
        n = len(rec)
        rows[b, :n, :4] = rec[:, :4] + rng.randn(n, 4) * 2
        rows[b, :n, 4:6] = rng.uniform(0.3, 1, (n, 2))
        rows[b, :n, 6] = rec[:, 4]
        rows[b, n:n + 3, :4] = [[5, 5, 30, 30]] * 3  # false positives
        rows[b, n:n + 3, 4:7] = [0.5, 0.5, 1]
        valid[b, :n + 3] = True
    info = [torch.full((4,), 96), torch.full((4,), 128)]
    ids = torch.tensor([[i] for i in ds.ids[:4]])
    port = COCOEvaluator(loader, SIZE, 3, per_class_AP=True, per_class_AR=True)
    ref = JEvaluator(loader, SIZE, 0.01, 0.65, 3, per_class_AP=True,
                     per_class_AR=True)
    dets = port.convert_to_coco_format(rows, valid, info, ids)
    assert dets == ref.convert_to_coco_format(Detections(rows, valid), info,
                                              ids)
    ap, ap50, summary = port.evaluate_prediction(dets)
    jap, jap50, jsummary = ref.evaluate_prediction(dets, (0.0, 0.0, 1))
    assert (ap, ap50) == (jap, jap50) and 0.2 < ap < 1
    assert summary.split("IoU=0.50:0.95")[1] == jsummary.split(
        "IoU=0.50:0.95")[1]  # the stats and the tables, past the timing line


def test_label_oracle_scores_ap_one(coco_dir):
    """Exp.get_evaluator over the val images, with the labels as detections
    (letterboxed pixels at test_size): AP 1."""
    exp = Exp()
    exp.data_dir, exp.test_size, exp.num_classes = coco_dir, SIZE, 3
    exp.data_num_workers = 0
    evaluator = exp.get_evaluator(batch_size=3)
    ap, ap50, _ = evaluator.evaluate(LabelOracle(evaluator.dataloader.dataset,
                                                 "cpu"))
    assert ap == pytest.approx(1.0) and ap50 == pytest.approx(1.0)
    assert evaluator.timings["images"] == 4
