"""A self-contained COCO API, the subset evaluation uses (counterpart of
``eop_tpu/data/coco_api.py``; no pycocotools).

* ``COCO``: the json index with getAnnIds / getCatIds / getImgIds /
  loadAnns / loadImgs / loadRes and annToRLE;
* the RLE codec: COCO's column-major uncompressed counts, and the decoder
  of the compressed string format;
* ``mask_iou`` for segmentation AP.  Polygon segmentations render with
  OpenCV (``polygons_to_mask``), which is imported only there.
"""

from __future__ import annotations

import copy
import itertools
import json
from collections import defaultdict
from typing import Dict, List

import numpy as np


# ---------------------------------------------------------------------------
# RLE codec (COCO "counts" format, column-major / Fortran order)
# ---------------------------------------------------------------------------

def mask_to_rle(mask: np.ndarray) -> Dict:
    """Binary mask [h, w] -> uncompressed RLE dict."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).ravel(order="F").astype(np.uint8)
    # runs of equal values, starting with zeros
    diff = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    boundaries = np.concatenate([[0], diff, [flat.size]])
    counts = np.diff(boundaries).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict) -> np.ndarray:
    """Uncompressed or compressed RLE -> binary mask [h, w] uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_rle_string(counts)
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    vals = np.zeros(total, dtype=np.uint8)
    ends = np.cumsum(counts)
    starts = ends - counts
    for i in range(1, len(counts), 2):  # odd runs are ones
        vals[starts[i]:ends[i]] = 1
    return vals.reshape((h, w), order="F")


def _decode_rle_string(s) -> List[int]:
    """COCO compressed RLE string -> counts (pycocotools rleFrString)."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def polygons_to_mask(polys: List[List[float]], h: int, w: int) -> np.ndarray:
    """Polygon segmentation -> binary mask [h, w] uint8 (cv2 rendering)."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("rendering polygon segmentations needs OpenCV "
                           "(cv2), which is not installed") from None
    mask = np.zeros((h, w), dtype=np.uint8)
    pts = [
        np.asarray(p, dtype=np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in polys
        if len(p) >= 6
    ]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def mask_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_rle_string(counts)
    return int(sum(counts[1::2]))


def mask_iou(dt_rles, gt_rles, iscrowd):
    """Pairwise mask IoU [len(dt), len(gt)] (pycocotools `maskUtils.iou`)."""
    d_masks = [rle_to_mask(r).astype(bool) for r in dt_rles]
    g_masks = [rle_to_mask(r).astype(bool) for r in gt_rles]
    out = np.zeros((len(d_masks), len(g_masks)))
    for j, g in enumerate(g_masks):
        ga = g.sum()
        for i, d in enumerate(d_masks):
            inter = np.logical_and(d, g).sum()
            union = d.sum() if iscrowd[j] else d.sum() + ga - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


# ---------------------------------------------------------------------------
# COCO index
# ---------------------------------------------------------------------------

class COCO:
    """Drop-in for pycocotools.coco.COCO (the subset the framework uses)."""

    def __init__(self, annotation_file: str | None = None):
        self.dataset: Dict = {}
        self.anns: Dict = {}
        self.cats: Dict = {}
        self.imgs: Dict = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            assert isinstance(self.dataset, dict)
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns, catToImgs = defaultdict(list), defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            catToImgs[ann["category_id"]].append(ann["image_id"])
        self.anns, self.cats, self.imgs = anns, cats, imgs
        self.imgToAnns, self.catToImgs = imgToAnns, catToImgs

    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None):
        imgIds = imgIds if isinstance(imgIds, (list, tuple)) else [imgIds]
        catIds = catIds if isinstance(catIds, (list, tuple)) else [catIds]
        if len(imgIds) == len(catIds) == len(areaRng) == 0:
            anns = self.dataset.get("annotations", [])
        else:
            if len(imgIds) > 0:
                anns = list(
                    itertools.chain.from_iterable(
                        self.imgToAnns[i] for i in imgIds
                    )
                )
            else:
                anns = self.dataset.get("annotations", [])
            if len(catIds) > 0:
                anns = [a for a in anns if a["category_id"] in catIds]
            if len(areaRng) > 0:
                anns = [
                    a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]
                ]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=[], supNms=[], catIds=[]):
        cats = self.dataset.get("categories", [])
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=[], catIds=[]):
        imgIds = imgIds if isinstance(imgIds, (list, tuple)) else [imgIds]
        catIds = catIds if isinstance(catIds, (list, tuple)) else [catIds]
        if len(imgIds) == len(catIds) == 0:
            return list(self.imgs.keys())
        ids = set(imgIds) if imgIds else None
        for i, cat_id in enumerate(catIds):
            if ids is None and i == 0:
                ids = set(self.catToImgs[cat_id])
            else:
                ids &= set(self.catToImgs[cat_id])
        return list(ids if ids is not None else self.imgs.keys())

    def loadAnns(self, ids=[]):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.anns[i] for i in ids]

    def loadCats(self, ids=[]):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.cats[i] for i in ids]

    def loadImgs(self, ids=[]):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.imgs[i] for i in ids]

    def loadRes(self, resFile):
        """Detection results (list of dicts or json path) -> result COCO."""
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset["images"]]
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = resFile
        assert isinstance(anns, list)
        if not anns:
            res.dataset["annotations"] = []
            res.dataset["categories"] = copy.deepcopy(
                self.dataset.get("categories", [])
            )
            res.createIndex()
            return res
        anns = copy.deepcopy(anns)
        if "bbox" in anns[0] and anns[0]["bbox"] != []:
            res.dataset["categories"] = copy.deepcopy(
                self.dataset.get("categories", [])
            )
            for i, ann in enumerate(anns):
                bb = ann["bbox"]
                if "segmentation" not in ann:
                    ann["segmentation"] = [
                        [bb[0], bb[1], bb[0], bb[1] + bb[3],
                         bb[0] + bb[2], bb[1] + bb[3], bb[0] + bb[2], bb[1]]
                    ]
                ann["area"] = bb[2] * bb[3]
                ann["id"] = i + 1
                ann["iscrowd"] = ann.get("iscrowd", 0)
        elif "segmentation" in anns[0]:
            res.dataset["categories"] = copy.deepcopy(
                self.dataset.get("categories", [])
            )
            for i, ann in enumerate(anns):
                rle = ann["segmentation"]
                ann["area"] = mask_area(rle)
                if "bbox" not in ann:
                    m = rle_to_mask(rle)
                    ys, xs = np.nonzero(m)
                    if len(xs):
                        ann["bbox"] = [
                            float(xs.min()), float(ys.min()),
                            float(xs.max() - xs.min() + 1),
                            float(ys.max() - ys.min() + 1),
                        ]
                    else:
                        ann["bbox"] = [0.0, 0.0, 0.0, 0.0]
                ann["id"] = i + 1
                ann["iscrowd"] = ann.get("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.createIndex()
        return res

    def annToRLE(self, ann) -> Dict:
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            return mask_to_rle(polygons_to_mask(segm, h, w))
        if isinstance(segm["counts"], list):
            return segm
        return {"size": segm["size"],
                "counts": _decode_rle_string(segm["counts"])}
