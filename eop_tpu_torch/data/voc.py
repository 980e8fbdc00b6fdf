"""The PASCAL VOC detection dataset (counterpart of
``eop_tpu/data/voc.py``): the xml annotations of a ``VOCdevkit`` tree,
annotations pre-scaled to the training size, images read by content
through ``image_io.imread`` (baseline JPEG without OpenCV), the optional
memmap cache, and VOC evaluation: one comp4 results file a class under
``<devkit>/results/VOC<year>/Main/``, :func:`~..eval.voc_eval.voc_eval`
over IoU 0.5:0.95 with its annotation cache under
``<devkit>/annotations_cache/``, and each class's PR curve as
``<output_dir>/<class>_pr.pkl``."""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np

from ..eval.voc_eval import voc_eval
from .cached_dataset import ResizedDetectionDataset
from .image_io import imread
from .voc_classes import VOC_CLASSES

_BOX_KEYS = ("xmin", "ymin", "xmax", "ymax")


class AnnotationTransform:
    """A VOC xml tree -> (rows ``[[x1, y1, x2, y2, label], ...]``, (h, w)).

    Coordinates become 0-based (VOC's are 1-based); ``difficult`` objects
    are dropped unless ``keep_difficult``."""

    def __init__(self, class_to_ind=None, keep_difficult=True):
        self.class_to_ind = class_to_ind or {
            name: i for i, name in enumerate(VOC_CLASSES)}
        self.keep_difficult = keep_difficult

    def __call__(self, target):
        rows = []
        for obj in target.iter("object"):
            difficult = (obj.findtext("difficult") or "0").strip() == "1"
            if difficult and not self.keep_difficult:
                continue
            box = obj.find("bndbox")
            rows.append([int(float(box.findtext(k))) - 1 for k in _BOX_KEYS]
                        + [self.class_to_ind[obj.find("name").text.strip()]])
        size = target.find("size")
        hw = (int(size.findtext("height")), int(size.findtext("width")))
        return np.array(rows, dtype=np.float64).reshape(-1, 5), hw


class VOCDetection(ResizedDetectionDataset):
    """VOC detection over one or more ``(year, image set)`` splits of the
    devkit at ``data_dir``.  Items are ``(image, labels, (h, w) of the raw
    image, index)``."""

    def __init__(self, data_dir,
                 image_sets=(("2007", "trainval"), ("2012", "trainval")),
                 img_size=(416, 416), preproc=None, target_transform=None,
                 dataset_name="VOC0712", cache=False):
        super().__init__(img_size, preproc=preproc)
        self.root = data_dir
        self.image_set = list(image_sets)
        self.target_transform = target_transform or AnnotationTransform()
        self.name = dataset_name
        self._classes = VOC_CLASSES
        self.ids = []
        for year, split in self.image_set:
            self._year = year
            year_root = os.path.join(self.root, "VOC" + year)
            listing = os.path.join(year_root, "ImageSets", "Main",
                                   split + ".txt")
            with open(listing) as f:
                self.ids.extend((year_root, stem) for stem in f.read().split())
        self.annotations = [self._build_record(i)
                            for i in range(len(self.ids))]
        if cache:
            self._cache_images()

    def _xml_path(self, index):
        year_root, stem = self.ids[index]
        return os.path.join(year_root, "Annotations", stem + ".xml")

    def _build_record(self, index):
        tree = ET.parse(self._xml_path(index)).getroot()
        labels, raw_hw = self.target_transform(tree)
        r = self.fit_ratio(raw_hw)
        labels[:, :4] *= r
        resized_hw = (int(raw_hw[0] * r), int(raw_hw[1] * r))
        return labels, raw_hw, resized_hw, None

    def load_image(self, index):
        year_root, stem = self.ids[index]
        return imread(os.path.join(year_root, "JPEGImages", stem + ".jpg"))

    def _cache_path(self):
        return os.path.join(self.root, f"img_resized_cache_{self.name}.array")

    # ------------------------------------------------------------------
    # VOC evaluation

    def evaluate_detections(self, all_boxes, output_dir=None):
        """mAP over IoU 0.5:0.95 of ``all_boxes[class][image]`` (rows ``[x1,
        y1, x2, y2, score]`` in the raw images' 0-based pixels); returns
        (mAP50:95, mAP50)."""
        self._write_results_files(all_boxes)
        thresholds = np.arange(0.5, 0.951, 0.05)
        maps = [self._eval_at_iou(output_dir, t) for t in thresholds]
        print("-" * 62)
        print("map_5095:", np.mean(maps))
        print("map_50:", maps[0])
        print("-" * 62)
        return np.mean(maps), maps[0]

    def _results_path(self, cls_name):
        outdir = os.path.join(self.root, "results", "VOC" + self._year, "Main")
        os.makedirs(outdir, exist_ok=True)
        return os.path.join(outdir, f"comp4_det_test_{cls_name}.txt")

    def _write_results_files(self, all_boxes):
        """One comp4 file a class: ``stem score x1 y1 x2 y2`` (1-based)."""
        for cls_ind, cls_name in enumerate(VOC_CLASSES):
            lines = []
            for (_, stem), dets in zip(self.ids, all_boxes[cls_ind]):
                for row in np.asarray(dets).reshape(-1, 5):
                    coords = " ".join(f"{v + 1:.1f}" for v in row[:4])
                    lines.append(f"{stem} {row[4]:.3f} {coords}\n")
            with open(self._results_path(cls_name), "wt") as f:
                f.writelines(lines)

    def _eval_at_iou(self, output_dir="output", iou=0.5):
        """The mean over the classes of their AP at ``iou`` (VOC07's
        11-point metric for years before 2010); at 0.5 it prints each
        class's AP and the mean."""
        year_root = os.path.join(self.root, "VOC" + self._year)
        split = self.image_set[0][1]
        cachedir = os.path.join(self.root, "annotations_cache",
                                "VOC" + self._year, split)
        os.makedirs(cachedir, exist_ok=True)
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
        aps = []
        for cls_name in VOC_CLASSES:
            rec, prec, ap = voc_eval(
                self._results_path(cls_name),
                os.path.join(year_root, "Annotations", "{:s}.xml"),
                os.path.join(year_root, "ImageSets", "Main", split + ".txt"),
                cls_name, cachedir, ovthresh=iou,
                use_07_metric=int(self._year) < 2010)
            aps.append(ap)
            if iou == 0.5:
                print(f"AP for {cls_name} = {ap:.4f}")
            if output_dir is not None:
                with open(os.path.join(output_dir, cls_name + "_pr.pkl"),
                          "wb") as f:
                    pickle.dump({"rec": rec, "prec": prec, "ap": ap}, f)
        if iou == 0.5:
            print(f"Mean AP = {np.mean(aps):.4f}")
        return np.mean(aps)
