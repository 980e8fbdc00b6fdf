"""PASCAL VOC per-class AP (counterpart of ``eop_tpu/eval/voc_eval.py``,
numpy only): the canonical py-faster-rcnn protocol, greedy
confidence-ordered matching with VOC's inclusive-pixel (+1) IoU, difficult
objects excluded, and the VOC07 11-point or VOC10+ area-under-envelope AP.
Matching is grouped by image over one IoU matrix, and both AP metrics are
suffix maxima, as in ``eop_tpu``."""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np


def parse_rec(filename):
    """One VOC xml annotation file -> list of object dicts."""

    def _int(node, tag):
        n = node.find(tag)
        return 0 if n is None else int(n.text)

    out = []
    # findall, not iter: only top-level <object> elements are objects
    for obj in ET.parse(filename).findall("object"):
        pose = obj.find("pose")
        box = obj.find("bndbox")
        out.append({
            "name": obj.find("name").text,
            "pose": "Unspecified" if pose is None else pose.text,
            "truncated": _int(obj, "truncated"),
            "difficult": _int(obj, "difficult"),
            "bbox": [int(float(box.find(t).text))
                     for t in ("xmin", "ymin", "xmax", "ymax")],
        })
    return out


def voc_ap(rec, prec, use_07_metric=False):
    """AP from a PR curve.

    VOC07: the mean over the 11 recall thresholds of the best precision at
    recall >= t, a suffix maximum of the precision indexed by
    ``searchsorted`` (recall never falls).  VOC10+: the area under the
    monotone precision envelope."""
    rec = np.asarray(rec, np.float64)
    prec = np.asarray(prec, np.float64)
    if use_07_metric:
        suffix_best = np.maximum.accumulate(prec[::-1])[::-1]
        idx = np.searchsorted(rec, np.arange(0.0, 1.1, 0.1), side="left")
        return float(
            sum(suffix_best[i] for i in idx if i < rec.size) / 11.0)
    r = np.concatenate(([0.0], rec, [1.0]))
    p = np.concatenate(([0.0], prec, [0.0]))
    p = np.maximum.accumulate(p[::-1])[::-1]
    steps = np.flatnonzero(np.diff(r))
    return float(np.sum(np.diff(r)[steps] * p[steps + 1]))


def _iou_inclusive(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """Pairwise IoU ``[n_det, n_gt]`` with VOC's inclusive pixels (a box is
    ``x2 - x1 + 1`` wide)."""
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt + 1.0, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]

    def area(b):
        return (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)

    return inter / (area(dets)[:, None] + area(gts)[None, :] - inter)


def _load_annotations(annopath, imagenames, cachedir):
    """Every image's objects, parsed or from ``cachedir/annots.pkl``."""
    os.makedirs(cachedir, exist_ok=True)
    cachefile = os.path.join(cachedir, "annots.pkl")
    if os.path.isfile(cachefile):
        with open(cachefile, "rb") as f:
            return pickle.load(f)
    recs = {name: parse_rec(annopath.format(name)) for name in imagenames}
    with open(cachefile, "wb") as f:
        pickle.dump(recs, f)
    return recs


def voc_eval(detpath, annopath, imagesetfile, classname, cachedir,
             ovthresh=0.5, use_07_metric=False):
    """(recall, precision, ap) of one class.

    ``detpath`` is a template of the class's results file (rows ``image_id
    score x1 y1 x2 y2``); an empty file gives ``(0.0, 0.0, 0.0)``."""
    with open(imagesetfile) as f:
        imagenames = [x.strip() for x in f]
    recs = _load_annotations(annopath, imagenames, cachedir)

    # the class's objects by image: (boxes [n, 4], difficult [n]); npos
    # counts the objects that are not difficult (recall's denominator)
    gt = {}
    npos = 0
    for name in imagenames:
        objs = [o for o in recs[name] if o["name"] == classname]
        boxes = np.array(
            [o["bbox"] for o in objs], np.float64).reshape(len(objs), 4)
        diff = np.array([bool(o["difficult"]) for o in objs], bool)
        npos += int((~diff).sum())
        gt[name] = (boxes, diff)

    with open(detpath.format(classname)) as f:
        rows = [ln.strip().split(" ") for ln in f if ln.strip()]
    if not rows:
        return 0.0, 0.0, 0.0
    ids = np.array([r[0] for r in rows])
    conf = np.array([r[1] for r in rows], np.float64)
    det_boxes = np.array([r[2:6] for r in rows], np.float64)

    order = np.argsort(-conf)  # the protocol's ties: a plain argsort
    ids, det_boxes = ids[order], det_boxes[order]

    # greedy matching by image: an object's claim is per image, so images
    # are independent while each visits its detections in global rank
    nd = ids.size
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for name in np.unique(ids):
        sel = np.flatnonzero(ids == name)
        gboxes, gdiff = gt[name]
        if not gboxes.size:
            fp[sel] = 1.0
            continue
        iou = _iou_inclusive(det_boxes[sel], gboxes)
        best = iou.argmax(axis=1)  # over every object, claimed or difficult
        best_iou = iou[np.arange(sel.size), best]
        claimed = np.zeros(gboxes.shape[0], bool)
        for i, d in enumerate(sel):
            if best_iou[i] <= ovthresh:
                fp[d] = 1.0
            elif gdiff[best[i]]:
                pass  # a difficult object absorbs it: neither tp nor fp
            elif claimed[best[i]]:
                fp[d] = 1.0  # a second detection of a matched object
            else:
                claimed[best[i]] = True
                tp[d] = 1.0

    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    rec = tp_cum / npos if npos > 0 else np.zeros_like(tp_cum)
    prec = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)
