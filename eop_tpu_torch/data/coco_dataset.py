"""COCO-format detection dataset (counterpart of
``eop_tpu/data/coco_dataset.py``): ``<data_dir>/annotations/<json_file>``
and the images under ``<data_dir>/<name>/``, read by content through
``image_io.imread`` (baseline JPEG, PNG, BMP, PPM without OpenCV).  Boxes
are cleaned (clipped to the image, empty ones dropped), pre-scaled to the
fit ratio and held as ``[x1, y1, x2, y2, cls]`` rows with ``cls`` the index
of the category in sorted id order."""

from __future__ import annotations

import os

import numpy as np

from .cached_dataset import ResizedDetectionDataset
from .coco_api import COCO
from .image_io import imread


def remove_useless_info(coco: COCO) -> None:
    """Drop the fields the pipeline never reads (segmentation, licences,
    URLs)."""
    payload = coco.dataset
    for key in ("info", "licenses"):
        payload.pop(key, None)
    for img in payload.get("images", []):
        for key in ("license", "coco_url", "date_captured", "flickr_url"):
            img.pop(key, None)
    for anno in payload.get("annotations", []):
        anno.pop("segmentation", None)


class COCODataset(ResizedDetectionDataset):
    """Items are ``(image, labels, (h, w) of the raw image, [image id])``;
    ``cache`` keeps the resized images in ``<data_dir>/
    img_resized_cache_<name>.array``."""

    def __init__(self, data_dir: str, json_file="instances_train2017.json",
                 name="train2017", img_size=(416, 416), preproc=None,
                 cache=False):
        super().__init__(img_size, preproc=preproc)
        if not data_dir:
            raise ValueError("COCODataset needs data_dir (the directory of "
                             "annotations/ and the image folders)")
        self.data_dir = data_dir
        self.json_file = json_file
        self.name = name
        self.coco = COCO(os.path.join(data_dir, "annotations", json_file))
        remove_useless_info(self.coco)
        self.ids = self.coco.getImgIds()
        self.class_ids = sorted(self.coco.getCatIds())
        self._label_of = {cid: i for i, cid in enumerate(self.class_ids)}
        self._classes = tuple(
            c["name"] for c in self.coco.loadCats(self.coco.getCatIds()))
        self.annotations = [self._build_record(i) for i in self.ids]
        if cache:
            self._cache_images()

    def _build_record(self, img_id):
        meta = self.coco.loadImgs(img_id)[0]
        h, w = meta["height"], meta["width"]
        anns = [a for a in self.coco.loadAnns(self.coco.getAnnIds(
            imgIds=[int(img_id)], iscrowd=False)) if a["area"] > 0]
        if anns:
            xywh = np.array([a["bbox"] for a in anns], dtype=np.float64)
            lo = np.maximum(xywh[:, :2], 0.0)
            hi = np.minimum(lo + np.maximum(xywh[:, 2:4], 0.0), (w, h))
            cls = np.array([self._label_of[a["category_id"]] for a in anns],
                           dtype=np.float64)
            rows = np.concatenate([lo, hi, cls[:, None]], axis=1)
            rows = rows[(hi >= lo).all(axis=1)]
        else:
            rows = np.zeros((0, 5), dtype=np.float64)
        r = self.fit_ratio((h, w))
        rows[:, :4] *= r
        resized_hw = (int(h * r), int(w * r))
        file_name = meta.get("file_name", f"{img_id:012}.jpg")
        return rows, (h, w), resized_hw, file_name

    def load_image(self, index):
        return imread(os.path.join(self.data_dir, self.name,
                                   self.annotations[index][3]))

    def _cache_path(self):
        return os.path.join(self.data_dir,
                            f"img_resized_cache_{self.name}.array")

    def sample_id(self, index):
        return np.array([self.ids[index]])
