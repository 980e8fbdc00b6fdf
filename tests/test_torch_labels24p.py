"""The 24-point label generator against ``eop_tpu`` and OpenCV on the CPU:
``ray_cast_24`` equal to ``eop_tpu``'s on seeded masks (touching each
border, one pixel, covering the image, empty); the hull area
``contour_area(convex_hull(p))`` equal to
``cv2.contourArea(cv2.convexHull(p))`` on 200 seeded integer point sets (repeated and collinear points among
them); ``Polygon24`` and ``python -m eop_tpu_torch.tools.labels_create_24p``
writing "Cord" and "Radius" txt files byte-equal to ``eop_tpu``'s on one
seeded COCO json (polygons, an RLE, a crowd, a zero area, an image whose
file is missing, an image whose labels all fail the gate); the rows read
back by ``COCO24PDataset``."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eop_tpu.data import labels24p as jax_labels
from eop_tpu_torch.data import labels24p
from eop_tpu_torch.data.coco_api import mask_to_rle
from eop_tpu_torch.data.geometry import contour_area, convex_hull
from eop_tpu_torch.tools import labels_create_24p
from eop_tpu_torch.utils.synth import write_polygon_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_masks():
    rng = np.random.RandomState(0)
    h, w = 40, 56
    yield "blob", (rng.rand(h, w) < 0.5).astype(np.uint8), 20.3, 17.8
    for side in ("top", "bottom", "left", "right"):
        m = np.zeros((h, w), np.uint8)
        sl = {"top": np.s_[:12, 10:40], "bottom": np.s_[-12:, 10:40],
              "left": np.s_[5:30, :15], "right": np.s_[5:30, -15:]}[side]
        m[sl] = 1
        ys, xs = np.nonzero(m)
        yield side, m, xs.mean() + 0.25, ys.mean() + 0.5
    one = np.zeros((h, w), np.uint8)
    one[17, 23] = 1
    yield "one_pixel", one, 23.5, 17.5
    yield "full", np.ones((h, w), np.uint8), w / 2, h / 2
    yield "empty", np.zeros((h, w), np.uint8), 11.0, 9.0
    for i in range(4):
        m = np.zeros((h, w), np.uint8)
        c = rng.uniform(0, [w, h])
        cv2.ellipse(m, (int(c[0]), int(c[1])),
                    (int(rng.randint(2, 30)), int(rng.randint(2, 20))),
                    float(rng.uniform(0, 180)), 0, 360, 1, -1)
        yield f"ellipse{i}", m, float(c[0] + rng.uniform(-2, 2)), float(
            c[1] + rng.uniform(-2, 2))


@pytest.mark.parametrize("case", list(seeded_masks()),
                         ids=[c[0] for c in seeded_masks()])
def test_ray_cast_24_equals_eop_tpu(case):
    _, mask, cx, cy = case
    got_p, got_r = labels24p.ray_cast_24(cx, cy, mask)
    want_p, want_r = jax_labels.ray_cast_24(cx, cy, mask)
    assert np.array_equal(got_p, want_p)
    assert np.array_equal(got_r, want_r)


def point_sets(n=200):
    rng = np.random.RandomState(1)
    for i in range(n):
        k = int(rng.randint(1, 30))
        kind = i % 5
        if kind == 0:    # repeated points
            p = np.repeat(rng.randint(0, 50, (max(1, k // 3), 2)), 3, 0)
        elif kind == 1:  # collinear
            a, d = rng.randint(-20, 20, 2), rng.randint(-5, 6, 2)
            p = a + np.outer(rng.randint(0, 10, k), d)
        elif kind == 2:  # one point
            p = np.repeat(rng.randint(-9, 9, (1, 2)), k, 0)
        else:
            p = rng.randint(0, 1000 if kind == 3 else 8, (k, 2))
        yield p.astype(np.int32)


def test_hull_area_equals_opencv():
    for p in point_sets():
        want = cv2.contourArea(cv2.convexHull(p))
        assert contour_area(convex_hull(p)) == want, p.tolist()
        assert contour_area(convex_hull(p.reshape(-1, 1, 2))) == want


@pytest.fixture(scope="module")
def coco_json(tmp_path_factory):
    """The seeded polygon dataset, plus an RLE annotation, a crowd one, a
    zero-area one, one whose image file is missing and an image whose one
    label fails the hull gate (its area far from the mask's)."""
    root = tmp_path_factory.mktemp("labels24p")
    img_dir, path = write_polygon_dataset(str(root), 3, (72, 96), objects=3,
                                          seed=5)
    data = json.load(open(path))
    rle_mask = np.zeros((72, 96), np.uint8)
    cv2.circle(rle_mask, (50, 30), 14, 1, -1)
    extra = [
        {"image_id": 1, "category_id": 44, "bbox": [36.0, 16.0, 29.0, 29.0],
         "area": float(rle_mask.sum()), "iscrowd": 0,
         "segmentation": mask_to_rle(rle_mask)},
        {"image_id": 2, "category_id": 1, "bbox": [1.0, 1.0, 9.0, 9.0],
         "area": 81.0, "iscrowd": 1,
         "segmentation": mask_to_rle(np.ones((72, 96), np.uint8))},
        {"image_id": 2, "category_id": 3, "bbox": [5.0, 5.0, 0.5, 0.5],
         "area": 0.25, "iscrowd": 0,
         "segmentation": [[5.0, 5.0, 5.5, 5.0, 5.5, 5.5]]},
        {"image_id": 4, "category_id": 18, "bbox": [10.0, 10.0, 20.0, 20.0],
         "area": 400.0, "iscrowd": 0,
         "segmentation": [[10.0, 10.0, 30.0, 10.0, 30.0, 30.0, 10.0, 30.0]]},
        {"image_id": 5, "category_id": 62, "bbox": [10.0, 10.0, 20.0, 20.0],
         "area": 4000.0, "iscrowd": 0,
         "segmentation": [[10.0, 10.0, 30.0, 10.0, 30.0, 30.0, 10.0, 30.0]]},
    ]
    for i, ann in enumerate(extra):
        ann["id"] = 100 + i
    data["annotations"] += extra
    data["images"] += [{"id": 4, "width": 96, "height": 72,
                        "file_name": "000000000004.jpg"},
                       {"id": 5, "width": 96, "height": 72,
                        "file_name": "000000000005.jpg"}]
    # image 5's file exists, image 4's does not
    with open(os.path.join(img_dir, "000000000005.jpg"), "wb") as f:
        f.write(b"")
    with open(path, "w") as f:
        json.dump(data, f)
    return img_dir, path


@pytest.mark.parametrize("mode", ["Cord", "Radius"])
def test_polygon24_files_equal_eop_tpu(coco_json, mode, tmp_path):
    img_dir, path = coco_json
    want = jax_labels.Polygon24(path, img_dir, str(tmp_path / "jax"), mode)
    want.process()
    want.save()
    got = labels24p.Polygon24(path, img_dir, str(tmp_path / "port"), mode)
    cord, radius = got.process()
    got.save()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "000000000004.txt" in names  # its rows skipped, its file kept
    sizes = {}
    for name in names:
        a = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == a, name
        sizes[name] = len(a)
    assert sizes["000000000005.txt"] == 0   # the gate dropped its label
    assert sum(v > 0 for v in sizes.values()) == 3
    assert sum(len(v) for v in cord.values()) >= 9
    assert len(cord) == len(radius)


def jax_cli_main(argv):
    spec = importlib.util.spec_from_file_location(
        "_jax_labels_create", os.path.join(ROOT, "tools",
                                           "labels_create_24p.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["labels_create_24p.py", *argv]
    try:
        mod.main()
    finally:
        sys.argv = old


def test_labels_create_cli_equals_eop_tpu_and_is_read(coco_json, tmp_path,
                                                      capsys):
    from eop_tpu_torch.data.coco24p import COCO24PDataset, TrainTransform24P

    img_dir, path = coco_json
    common = ["--json", path, "--images", img_dir, "--area-low", "0.6",
              "--area-high", "1.4"]
    jax_cli_main([*common, "--out", str(tmp_path / "jax")])
    labels_create_24p.main([*common, "--out", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert f"labels written to {tmp_path / 'port'}" in out
    assert "annotations" in out  # the progress count, without tqdm
    for name in os.listdir(tmp_path / "jax"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    ds = COCO24PDataset(data_dir=img_dir, label_dir=str(tmp_path / "port"),
                        img_size=(64, 64), preproc=TrainTransform24P())
    img, target, hw, img_id = ds[ds.image_list.index("000000000001.jpg")]
    rows = ds.coco24p_dict["000000000001"]
    assert rows.shape == (4, 51) and hw == (72, 96) and img_id[0] == 1
    assert target.shape == (50, 51) and (target[:4, 3:] != 0).all()
    assert img.shape == (64, 64, 3)


def test_dataset_writers_give_the_same_files_in_processes(tmp_path):
    """The seeded datasets' JPEGs encoded in two spawned processes are the
    bytes one process writes."""
    from eop_tpu_torch.utils.synth import write_coco_dataset

    roots = [str(tmp_path / f"w{n}") for n in (1, 2)]
    for root, workers in zip(roots, (1, 2)):
        write_coco_dataset(root, 3, 1, (40, 56), num_classes=3, seed=2,
                           workers=workers)
    for split in ("train2017", "val2017", "annotations"):
        names = sorted(os.listdir(os.path.join(roots[0], split)))
        assert names == sorted(os.listdir(os.path.join(roots[1], split)))
        for name in names:
            with open(os.path.join(roots[0], split, name), "rb") as a, \
                    open(os.path.join(roots[1], split, name), "rb") as b:
                assert a.read() == b.read(), name
