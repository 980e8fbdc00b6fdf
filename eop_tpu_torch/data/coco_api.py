"""A self-contained COCO API, the subset evaluation uses (counterpart of
``eop_tpu/data/coco_api.py``; no pycocotools).

* ``COCO``: the json index with getAnnIds / getCatIds / getImgIds /
  loadAnns / loadImgs / loadRes and annToRLE;
* the RLE codec: COCO's column-major uncompressed counts, and the decoder
  of the compressed string format;
* ``mask_iou`` for segmentation AP.  Polygon segmentations render with
  :func:`fill_poly`, ``cv2.fillPoly`` written in numpy
  (``polygons_to_mask``).
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


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def clip_line(w: int, h: int, p1, p2):
    """OpenCV's ``clipLine`` on integer points: the segment's part inside
    ``[0, w) x [0, h)`` as (inside, p1, p2).  The crossings are computed
    in double, as OpenCV does: exact for products below 2**53, and equal
    to OpenCV's beyond (16.16 points, ``utils/visualize.py``)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def draw_line(img: np.ndarray, p1, p2, value) -> None:
    """An 8-connected line between integer points, OpenCV's ``LineIterator``
    (Bresenham, walked left to right, clipped to the image)."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        inside, p1, p2 = clip_line(w, h, p1, p2)
        if not inside:
            return
    (x, y), (x2, y2) = p1, p2
    dx, dy = x2 - x, y2 - y
    if dx < 0:
        dx, dy, x, y = -dx, -dy, x2, y2
    step_y = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    for _ in range(major + 1):
        img[y, x] = value
        bump = err < 0
        err += -2 * minor + (2 * major if bump else 0)
        if vert:
            y += step_y
            x += 1 if bump else 0
        else:
            x += 1
            y += step_y if bump else 0


def fill_poly(img: np.ndarray, polys, value) -> np.ndarray:
    """``cv2.fillPoly(img, polys, value)`` for integer vertices (shift 0,
    8-connected), in numpy: every edge drawn as a line, then the scanline
    fill of all the polygons' edges together (even-odd across them, as
    OpenCV collects one edge list).  Edge x in 16.16 fixed point from its
    upper vertex, its slope truncated toward zero; a row fills from
    ``ceil(x_left)`` to ``floor(x_right)`` between consecutive active edges
    in x order; an edge is active on rows ``[y0, y1)``."""
    h, w = img.shape[:2]
    edges = []  # (y0, y1, x at y0, dx), fixed point
    for poly in polys:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        for i in range(len(pts)):
            (x0, y0), (x1, y1) = pts[i - 1], pts[i]
            draw_line(img, (x0, y0), (x1, y1), value)
            # a segment leaving the image takes its slope from its clipped
            # part (where that part is not horizontal)
            c0, c1 = (x0, y0), (x1, y1)
            if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h
                    and 0 <= y1 < h):
                _, t0, t1 = clip_line(w, h, c0, c1)
                if t0[1] != t1[1]:
                    c0, c1 = t0, t1
            if y0 == y1:
                continue
            # C division of the 16.16 run: toward zero
            run, rise = (c1[0] - c0[0]) << _XY_SHIFT, c1[1] - c0[1]
            dx = abs(run) // abs(rise) * (1 if (run < 0) == (rise < 0)
                                          else -1)
            if y0 < y1:
                edges.append((y0, y1, (c0[0] << _XY_SHIFT)
                              + (y0 - c0[1]) * dx, dx))
            else:
                edges.append((y1, y0, (c1[0] << _XY_SHIFT)
                              + (y1 - c1[1]) * dx, dx))
    if len(edges) < 2:
        return img
    y_lo = max(min(e[0] for e in edges), 0)
    y_hi = min(max(e[1] for e in edges), h)
    for y in range(y_lo, y_hi):
        xs = sorted(x + (y - y0) * dx for y0, y1, x, dx in edges
                    if y0 <= y < y1)
        for a, b in zip(xs[0::2], xs[1::2]):
            x1, x2 = (a + _XY_ONE - 1) >> _XY_SHIFT, b >> _XY_SHIFT
            if x1 < w and x2 >= 0:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = value
    return img


def polygons_to_mask(polys: List[List[float]], h: int, w: int) -> np.ndarray:
    """Polygon segmentation -> binary mask [h, w] uint8: the vertices
    rounded, then :func:`fill_poly` (``cv2.fillPoly`` in numpy; no OpenCV
    needed)."""
    mask = np.zeros((h, w), dtype=np.uint8)
    pts = [
        np.asarray(p, dtype=np.float64).reshape(-1, 2).round().astype(np.int64)
        for p in polys
        if len(p) >= 6
    ]
    if pts:
        fill_poly(mask, pts, 1)
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

    def annToMask(self, ann) -> np.ndarray:
        """The annotation's binary mask [h, w] uint8."""
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            return polygons_to_mask(segm, h, w)
        return rle_to_mask(segm if isinstance(segm["counts"], list)
                           else self.annToRLE(ann))
