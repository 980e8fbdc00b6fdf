"""COCO AP evaluation, pycocotools-compatible (counterpart of
``eop_tpu/eval/coco_eval.py``): the same Params, evaluate / accumulate /
summarize API, printed summary and ``stats``, in float64 numpy, with the
greedy matcher in C++ (``fast_cocoeval``).
"""

from __future__ import annotations

import copy
import datetime
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np

from ..data.coco_api import mask_iou
from .fast_cocoeval import match_image


class Params:
    """Evaluation parameters (pycocotools `Params`)."""

    def __init__(self, iouType: str = "bbox"):
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.iouThrs = np.linspace(
            0.5, 0.95, int(np.round((0.95 - 0.5) / 0.05)) + 1
        )
        self.recThrs = np.linspace(
            0.0, 1.00, int(np.round((1.00 - 0.0) / 0.01)) + 1
        )
        self.maxDets = [1, 10, 100]
        self.areaRng = [
            [0**2, 1e5**2], [0**2, 32**2], [32**2, 96**2], [96**2, 1e5**2]
        ]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1
        self.iouType = iouType


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU on [x, y, w, h] boxes; vs crowd GTs the union is the
    detection area only (pycocotools `maskUtils.iou` bbox branch)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(
        np.minimum(dx2[:, None], gx2[None]) -
        np.maximum(dx1[:, None], gx1[None]),
        0, None,
    )
    ih = np.clip(
        np.minimum(dy2[:, None], gy2[None]) -
        np.maximum(dy1[:, None], gy1[None]),
        0, None,
    )
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area,
                     d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOeval:
    """pycocotools-compatible COCO evaluation."""

    def __init__(self, cocoGt=None, cocoDt=None, iouType: str = "bbox"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.evalImgs = defaultdict(list)
        self.eval: Dict = {}
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        self.params = Params(iouType=iouType)
        self._paramsEval: Params = None
        self.stats: np.ndarray = []
        self.ious: Dict = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # ------------------------------------------------------------------

    def _prepare(self):
        p = self.params
        if p.useCats:
            gts = self.cocoGt.loadAnns(
                self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds)
            )
            dts = self.cocoDt.loadAnns(
                self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds)
            )
        else:
            gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(imgIds=p.imgIds))
            dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(imgIds=p.imgIds))

        for gt in gts:
            gt["ignore"] = gt.get("ignore", 0) or gt.get("iscrowd", 0)
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)
        self.evalImgs = defaultdict(list)
        self.eval = {}

    def computeIoU(self, imgId, catId):
        p = self.params
        if p.useCats:
            gt = self._gts[imgId, catId]
            dt = self._dts[imgId, catId]
        else:
            gt = [g for c in p.catIds for g in self._gts[imgId, c]]
            dt = [d for c in p.catIds for d in self._dts[imgId, c]]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((len(dt), len(gt)))
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds]
        if len(dt) > p.maxDets[-1]:
            dt = dt[: p.maxDets[-1]]
        iscrowd = np.asarray([int(g.get("iscrowd", 0)) for g in gt])
        if p.iouType == "segm":
            g_rles = [self.cocoGt.annToRLE(g) for g in gt]
            d_rles = [self.cocoDt.annToRLE(d) for d in dt]
            return mask_iou(d_rles, g_rles, iscrowd)
        d_boxes = np.asarray([d["bbox"] for d in dt], np.float64)
        g_boxes = np.asarray([g["bbox"] for g in gt], np.float64)
        return bbox_iou_xywh(d_boxes, g_boxes, iscrowd)

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        p = self.params
        if p.useCats:
            gt = self._gts[imgId, catId]
            dt = self._dts[imgId, catId]
        else:
            gt = [g for c in p.catIds for g in self._gts[imgId, c]]
            dt = [d for c in p.catIds for d in self._dts[imgId, c]]
        if len(gt) == 0 and len(dt) == 0:
            return None

        for g in gt:
            g["_ignore"] = int(
                g["ignore"] or g["area"] < aRng[0] or g["area"] > aRng[1]
            )
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = np.asarray([int(g.get("iscrowd", 0)) for g in gt], np.int32)
        ious = (
            self.ious[imgId, catId][:, gtind]
            if len(self.ious[imgId, catId]) > 0
            else self.ious[imgId, catId]
        )
        # computeIoU already emitted rows in stable score-sorted order (and
        # truncated to maxDets[-1]); the same stable sort above reproduces
        # that ordering for dt, so rows only need truncating to maxDet —
        # re-permuting by dtind would misalign them (pycocotools keeps the
        # row order and indexes only dind < maxDet).
        ious = ious[:maxDet] if len(ious) > 0 else ious

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtIg = np.asarray([g["_ignore"] for g in gt], np.int32)
        dt_oor = np.asarray(
            [int(d["area"] < aRng[0] or d["area"] > aRng[1]) for d in dt],
            np.int32,
        )
        if D and G:
            dtm_idx, gtm_idx, dtIg = match_image(
                p.iouThrs, np.asarray(ious, np.float64), gtIg, iscrowd,
                dt_oor,
            )
        else:
            dtm_idx = np.zeros((T, D), np.int64)
            gtm_idx = np.zeros((T, G), np.int64)
            dtIg = np.tile(dt_oor[None], (T, 1)) if D else np.zeros(
                (T, D), np.int32
            )

        gt_ids = np.asarray([g["id"] for g in gt], np.int64)
        dt_ids = np.asarray([d["id"] for d in dt], np.int64)
        # index+1 -> original annotation ids (0 stays unmatched); np.where
        # evaluates both branches, so guard the empty-side lookups
        dtm = (
            np.where(dtm_idx > 0, gt_ids[dtm_idx - 1], 0)
            if G else np.zeros_like(dtm_idx)
        )
        gtm = (
            np.where(gtm_idx > 0, dt_ids[gtm_idx - 1], 0)
            if D else np.zeros_like(gtm_idx)
        )

        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg.astype(bool),
        }

    def evaluate(self):
        tic = time.time()
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)
        self.params = p
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        self.ious = {
            (imgId, catId): self.computeIoU(imgId, catId)
            for imgId in p.imgIds
            for catId in catIds
        }
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds
        ]
        self._paramsEval = copy.deepcopy(self.params)
        self._eval_toc = time.time() - tic

    def accumulate(self, p=None):
        if not self.evalImgs:
            print("Please run evaluate() first")
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        _pe = self._paramsEval
        setK = set(_pe.catIds)
        setA = set(map(tuple, _pe.areaRng))
        setM = set(_pe.maxDets)
        setI = set(_pe.imgIds)
        k_list = [n for n, k in enumerate(p.catIds) if k in setK]
        m_list = [m for n, m in enumerate(p.maxDets) if m in setM]
        a_list = [
            n for n, a in enumerate(map(lambda x: tuple(x), p.areaRng))
            if a in setA
        ]
        i_list = [n for n, i in enumerate(p.imgIds) if i in setI]
        I0 = len(_pe.imgIds)
        A0 = len(_pe.areaRng)
        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, maxDet in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate(
                        [e["dtScores"][0:maxDet] for e in E]
                    )
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, 0:maxDet] for e in E], axis=1
                    )[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, 0:maxDet] for e in E], axis=1
                    )[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dtIg)
                    )
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        pr = pr.tolist()
                        q = q.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        try:
                            for ri, pi in enumerate(inds_r):
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        except IndexError:
                            pass
                        precision[t, :, k, a, m] = np.array(q)
                        scores[t, :, k, a, m] = np.array(ss)
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    def summarize(self):
        def _summarize(ap=1, iouThr=None, areaRng="all", maxDets=100):
            p = self.params
            iStr = (
                " {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ]"
                " = {:0.3f}"
            )
            titleStr = "Average Precision" if ap == 1 else "Average Recall"
            typeStr = "(AP)" if ap == 1 else "(AR)"
            iouStr = (
                "{:0.2f}:{:0.2f}".format(p.iouThrs[0], p.iouThrs[-1])
                if iouThr is None
                else "{:0.2f}".format(iouThr)
            )
            aind = [
                i for i, a in enumerate(p.areaRngLbl) if a == areaRng
            ]
            mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
            if ap == 1:
                s = self.eval["precision"]
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, :, aind, mind]
            else:
                s = self.eval["recall"]
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, aind, mind]
            mean_s = -1 if len(s[s > -1]) == 0 else np.mean(s[s > -1])
            print(iStr.format(titleStr, typeStr, iouStr, areaRng, maxDets,
                              mean_s))
            return mean_s

        def _summarizeDets():
            stats = np.zeros((12,))
            stats[0] = _summarize(1)
            stats[1] = _summarize(1, iouThr=0.5, maxDets=self.params.maxDets[2])
            stats[2] = _summarize(1, iouThr=0.75,
                                  maxDets=self.params.maxDets[2])
            stats[3] = _summarize(1, areaRng="small",
                                  maxDets=self.params.maxDets[2])
            stats[4] = _summarize(1, areaRng="medium",
                                  maxDets=self.params.maxDets[2])
            stats[5] = _summarize(1, areaRng="large",
                                  maxDets=self.params.maxDets[2])
            stats[6] = _summarize(0, maxDets=self.params.maxDets[0])
            stats[7] = _summarize(0, maxDets=self.params.maxDets[1])
            stats[8] = _summarize(0, maxDets=self.params.maxDets[2])
            stats[9] = _summarize(0, areaRng="small",
                                  maxDets=self.params.maxDets[2])
            stats[10] = _summarize(0, areaRng="medium",
                                   maxDets=self.params.maxDets[2])
            stats[11] = _summarize(0, areaRng="large",
                                   maxDets=self.params.maxDets[2])
            return stats

        if not self.eval:
            raise Exception("Please run accumulate() first")
        self.stats = _summarizeDets()

    def __str__(self):
        self.summarize()
        return ""
