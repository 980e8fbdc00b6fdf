"""The mask viewer against ``eop_tpu`` and OpenCV on the CPU:
``find_contours_external`` point for point equal to
``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` (the list's
order too) on seeded masks: noise, rings holding islands, components
touching the image's edges, single pixels, lines, COCO polygon masks; and
``python -m eop_tpu_torch.tools.show_mask`` against ``tools/show_mask.py``
(loaded by path) on a seeded COCO json: the written images equal with cv2
present, and with cv2 made unimportable the contours equal
``cv2.drawContours``' (the labels are not drawn)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eop_tpu_torch.data.coco_api import COCO
from eop_tpu_torch.data.geometry import find_contours_external
from eop_tpu_torch.data.image_io import imread
from eop_tpu_torch.tools import show_mask
from eop_tpu_torch.utils import visualize
from eop_tpu_torch.utils.synth import write_polygon_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def masks(kind, n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        if kind == "noise":
            h, w = (int(v) for v in rng.randint(1, 16, 2))
            yield (rng.rand(h, w) < rng.uniform(0.1, 0.9)).astype(np.uint8)
        elif kind == "rings":
            m = np.zeros((32, 32), np.uint8)
            c = (int(rng.randint(8, 24)), int(rng.randint(8, 24)))
            cv2.circle(m, c, int(rng.randint(7, 16)), 1, -1)
            cv2.circle(m, c, int(rng.randint(2, 7)), 0, -1)
            if rng.rand() < 0.8:
                cv2.circle(m, (c[0] + int(rng.randint(-2, 3)),
                               c[1] + int(rng.randint(-2, 3))),
                           int(rng.randint(0, 2)), 1, -1)
            yield m
        elif kind == "edges":
            m = (rng.rand(20, 24) < 0.15).astype(np.uint8)
            m[0, :] = m[-1, :] = rng.rand(24) < 0.7
            m[:, 0] = m[:, -1] = rng.rand(20) < 0.7
            yield m
        elif kind == "lines":
            m = np.zeros((24, 24), np.uint8)
            for _ in range(int(rng.randint(1, 4))):
                p = rng.randint(0, 24, 4)
                cv2.line(m, (int(p[0]), int(p[1])), (int(p[2]), int(p[3])),
                         1, 1)
            m[rng.randint(0, 24, 3), rng.randint(0, 24, 3)] = 1
            yield m
        else:  # COCO polygons, 0/1 as annToMask gives them
            m = np.zeros((60, 80), np.uint8)
            k = int(rng.randint(3, 12))
            c = rng.uniform([10, 10], [70, 50])
            r = rng.uniform(3, 25, k)
            a = np.sort(rng.uniform(0, 2 * np.pi, k))
            pts = np.stack([c[0] + r * np.cos(a), c[1] + r * np.sin(a)], 1)
            cv2.fillPoly(m, [pts.round().astype(np.int32)], 1)
            yield m


KINDS = ("noise", "rings", "edges", "lines", "polygons")


@pytest.mark.parametrize("kind", KINDS)
def test_find_contours_external_equals_opencv(kind):
    for mask in masks(kind, 150 if kind == "noise" else 60, len(kind)):
        want, _ = cv2.findContours(mask.copy(), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        got = find_contours_external(mask)
        assert len(got) == len(want), mask.tolist()
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and np.array_equal(g, w), \
                mask.tolist()


def test_find_contours_external_edge_cases():
    assert find_contours_external(np.zeros((5, 6), np.uint8)) == []
    full = find_contours_external(np.full((5, 6), 7, np.uint8))
    assert [c.reshape(-1, 2).tolist() for c in full] == [
        [[0, 0], [0, 4], [5, 4], [5, 0]]]
    with pytest.raises(ValueError):
        find_contours_external(np.zeros((2, 2, 3), np.uint8))


def jax_show_mask_main(argv):
    spec = importlib.util.spec_from_file_location(
        "_jax_show_mask", os.path.join(ROOT, "tools", "show_mask.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["show_mask.py", *argv]
    try:
        mod.main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("showmask")
    return write_polygon_dataset(str(root), 2, (90, 120), objects=4, seed=7)


@pytest.mark.parametrize("image_id", [None, 2])
def test_show_mask_equals_eop_tpu(dataset, image_id, tmp_path):
    img_dir, path = dataset
    argv = ["--json", path, "--images", img_dir] + (
        ["--image-id", str(image_id)] if image_id else [])
    jax_show_mask_main([*argv, "--out", str(tmp_path / "jax.png")])
    out = show_mask.main([*argv, "--out", str(tmp_path / "port.png")])
    got = imread(out)
    assert np.array_equal(got, cv2.imread(str(tmp_path / "jax.png")))
    coco = COCO(path)
    name = coco.loadImgs(image_id or 1)[0]["file_name"]
    assert not np.array_equal(got, imread(os.path.join(img_dir, name)))


def test_show_mask_without_cv2_draws_opencvs_contours(dataset, tmp_path,
                                                     monkeypatch):
    img_dir, path = dataset
    coco = COCO(path)
    anns = coco.loadAnns(coco.getAnnIds(imgIds=1))
    image = imread(os.path.join(img_dir, "000000000001.jpg"))
    want = image.copy()
    for ann in anns:
        contours, _ = cv2.findContours(coco.annToMask(ann),
                                       cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        color = (visualize._COLORS[ann["category_id"] % 80] * 255).astype(
            np.uint8).tolist()
        cv2.drawContours(want, contours, -1, color, 2)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(visualize, "_warned", [True])
    out = show_mask.main(["--json", path, "--images", img_dir, "--out",
                          str(tmp_path / "m.bmp")])
    assert np.array_equal(imread(out), want)
