"""COCO box AP of the bbox family (counterpart of
``eop_tpu/eval/coco_evaluator.py``): the batched evaluation loop over the
val loader, detections rescaled to the raw images as COCO result dicts,
the port's COCOeval, and the per-class AP / AR tables as markdown (the same
text ``tabulate``'s ``pipe`` format prints, without the package).  With
``testdev`` the results go through ``./yolox_testdev_2017.json`` in the
working directory, as ``eop_tpu`` writes them.  Given a decode-only
function, the summary splits the inference time into forward and NMS by
:func:`estimate_nms_time`."""

from __future__ import annotations

import contextlib
import io
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .coco_eval import COCOeval


def markdown_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    """A left-aligned pipe table: floats as ``.3f``, None as an empty cell,
    every column at least its header's width plus two."""
    cells = [[("" if v is None else format(v, ".3f") if isinstance(v, float)
               else str(v)) for v in row] for row in rows]
    widths = [max([len(h) + 2] + [len(r[i]) for r in cells])
              for i, h in enumerate(headers)]

    def line(values):
        return "| " + " | ".join(v.ljust(w) for v, w in zip(values, widths)) \
            + " |"

    sep = "|" + "|".join(":" + "-" * (w + 1) for w in widths) + "|"
    return "\n".join([line(headers), sep] + [line(r) for r in cells])


def _folded_metric_table(values: Dict[str, float], metric: str,
                         pairs_per_row: int = 3) -> str:
    """{class: value} as a markdown table of ``pairs_per_row`` (class,
    value) column pairs, the classes in row-major order."""
    names = list(values)
    pairs_per_row = max(1, min(pairs_per_row, len(names)))
    rows = []
    for start in range(0, len(names), pairs_per_row):
        chunk = names[start: start + pairs_per_row]
        row = []
        for name in chunk:
            row += [name, values[name]]
        rows.append(row + [None] * (2 * (pairs_per_row - len(chunk))))
    return markdown_table(["class", metric] * pairs_per_row, rows)


def _masked_mean_pct(slab: np.ndarray) -> float:
    """COCOeval marks absent entries -1: the mean of the rest, in percent."""
    present = slab[slab > -1]
    return float(100 * present.mean()) if present.size else float("nan")


def per_class_AR_table(coco_eval, class_names) -> str:
    """Recall per class at area "all" and the last maxDets."""
    recalls = coco_eval.eval["recall"]  # [T, K, A, M]
    assert len(class_names) == recalls.shape[1]
    return _folded_metric_table(
        {name: _masked_mean_pct(recalls[:, k, 0, -1])
         for k, name in enumerate(class_names)}, "AR")


def per_class_AP_table(coco_eval, class_names) -> str:
    """Precision per class at area "all" and the last maxDets."""
    precisions = coco_eval.eval["precision"]  # [T, R, K, A, M]
    assert len(class_names) == precisions.shape[2]
    return _folded_metric_table(
        {name: _masked_mean_pct(precisions[:, :, k, 0, -1])
         for k, name in enumerate(class_names)}, "AP")


def _wait(out) -> None:
    """Wait for ``out`` (a tensor, or ``Detections``) without copying it:
    on the card ``torch.cuda.synchronize``; CPU results are done."""
    t = out if isinstance(out, torch.Tensor) else out.rows
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def estimate_nms_time(infer_fn: Callable, decode_fn: Callable, imgs,
                      reps: int = 3) -> float:
    """Seconds of NMS in one call of ``infer_fn`` on ``imgs``: the best of
    ``reps`` timed calls of ``infer_fn`` (forward, decode, NMS) less the
    best of ``reps`` of ``decode_fn`` (forward and decode), each after one
    untimed call, at least 0."""

    def timed(fn):
        _wait(fn(imgs))
        best = float("inf")
        for _ in range(reps):
            start = time.perf_counter()
            _wait(fn(imgs))
            best = min(best, time.perf_counter() - start)
        return best

    return max(0.0, timed(infer_fn) - timed(decode_fn))


def run_batches(dataloader, infer_fn: Callable, convert: Callable,
                decode_fn: Optional[Callable] = None):
    """The evaluation loop both box evaluators share: ``infer_fn`` over the
    loader's batches, ``convert(rows, valid, info_imgs, ids)`` of each
    batch's detections on the host.  The first batch runs once more,
    untimed, before its timed call; each timed call ends in the host copy
    of its detections, which waits for the device.  With ``decode_fn`` the
    NMS share is estimated on the first batch (:func:`estimate_nms_time`,
    once for each batch, at most the total).  Returns (the converted
    results in order, timings: seconds and counts)."""
    results = []
    inference_time = data_wait = first_wait = 0.0
    n_batches = n_images = 0
    first_imgs = None
    batches = iter(dataloader)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        data_wait += time.perf_counter() - t0
        if batch is None:
            break
        imgs, _, info_imgs, ids = batch
        if n_batches == 0:
            first_wait, first_imgs = data_wait, imgs
            infer_fn(imgs).rows.cpu()
        start = time.perf_counter()
        dets = infer_fn(imgs)
        rows = dets.rows.float().cpu().numpy()
        valid = dets.valid.cpu().numpy()
        inference_time += time.perf_counter() - start
        n_batches += 1
        n_images += rows.shape[0]
        results.append(convert(rows, valid, info_imgs, ids))
    nms_time = 0.0
    if decode_fn is not None and first_imgs is not None:
        nms_time = min(estimate_nms_time(infer_fn, decode_fn, first_imgs)
                       * n_batches, inference_time)
    return results, {"batches": n_batches, "images": n_images,
                     "inference_s": inference_time, "nms_s": nms_time,
                     "data_wait_s": data_wait,
                     "first_batch_wait_s": first_wait}


def time_summary(inference_s: float, nms_s: float, denom: int,
                 per: str = "") -> str:
    """``eop_tpu``'s line of the forward, NMS and inference averages in ms
    over ``denom``: COCO's (``per=""``, the NMS time "(estimated)") or
    VOC's (``per=" per batch"``)."""
    forward = 1000 * (inference_s - nms_s) / denom
    nms = 1000 * nms_s / denom
    nms_name = f"NMS time{per}" if per else "NMS time (estimated)"
    return (f"Average forward time{per}: {forward:.2f} ms, "
            f"Average {nms_name}: {nms:.2f} ms, "
            f"Average inference time{per}: {forward + nms:.2f} ms\n")


class COCOEvaluator:
    """COCO box AP over a val loader of ``COCODataset`` batches.

    After :meth:`evaluate`, ``timings`` holds the seconds spent waiting for
    the loader (and for its first batch, which includes starting its
    workers), in the timed inference calls, in NMS (estimated, 0 without a
    decode-only function) and in COCOeval, with the image, batch and
    detection counts.
    """

    def __init__(self, dataloader, img_size, num_classes: int,
                 per_class_AP: bool = False, per_class_AR: bool = False,
                 testdev: bool = False):
        self.dataloader = dataloader
        self.img_size = img_size
        self.num_classes = num_classes
        self.per_class_AP = per_class_AP
        self.per_class_AR = per_class_AR
        self.testdev = testdev
        self.timings: dict = {}

    def evaluate(self, infer_fn: Callable,
                 decode_fn: Optional[Callable] = None,
                 distributed: bool = False):
        """Returns (ap50_95, ap50, summary).

        ``infer_fn`` maps a letterboxed batch to ``Detections`` and must be
        pure (:func:`run_batches`).  ``decode_fn`` (forward and decode, no
        NMS) splits the summary's time into forward and NMS; without it
        the NMS time is 0.  ``distributed``: the loader holds this rank's
        share of the set; every rank's detections are gathered
        (``parallel.dist.all_gather``) and every rank scores them all, one
        rank at a time (``--testdev`` writes a file in the working
        directory)."""
        parts, timings = run_batches(self.dataloader, infer_fn,
                                     self.convert_to_coco_format, decode_fn)
        data_list = [d for part in parts for d in part]
        if distributed:
            from ..parallel.dist import all_gather

            data_list = [d for part in all_gather(data_list) for d in part]
        self.timings = {**timings, "detections": len(data_list),
                        "cocoeval_s": 0.0}

        def score():
            return self.evaluate_prediction(
                data_list, (timings["inference_s"], timings["nms_s"],
                            max(timings["batches"], 1)))

        if distributed:
            from ..parallel.dist import in_rank_order

            return in_rank_order(score)
        return score()

    def convert_to_coco_format(self, rows: np.ndarray, valid: np.ndarray,
                               info_imgs, ids) -> List[dict]:
        """Rows ``[B, max_det, 7]`` and their valid mask -> COCO result
        dicts in the raw images' pixels, with the dataset's category ids."""
        out = []
        img_hs, img_ws = np.asarray(info_imgs[0]), np.asarray(info_imgs[1])
        class_ids = getattr(self.dataloader.dataset, "class_ids",
                            list(range(self.num_classes)))
        ids = np.asarray(ids).reshape(-1)
        for b in range(rows.shape[0]):
            scale = min(self.img_size[0] / float(img_hs[b]),
                        self.img_size[1] / float(img_ws[b]))
            for r in rows[b][valid[b].astype(bool)]:
                x1, y1, x2, y2, obj, cls_conf, cls_pred = r[:7]
                out.append({
                    "image_id": int(ids[b]),
                    "category_id": class_ids[int(cls_pred)],
                    "bbox": [float(x1 / scale), float(y1 / scale),
                             float((x2 - x1) / scale),
                             float((y2 - y1) / scale)],
                    "score": float(obj * cls_conf),
                    "segmentation": [],
                })
        return out

    def evaluate_prediction(self, data_list: List[dict],
                            statistics=(0.0, 0.0, 1)):
        """COCO result dicts -> COCOeval -> (ap50_95, ap50, summary).
        ``statistics`` is (inference seconds, NMS seconds, batches); the
        summary's times are per image (per batch where the loader has no
        ``batch_size``), as ``eop_tpu`` averages them."""
        inference_time, nms_time, n_batches = statistics
        batch_size = getattr(self.dataloader, "batch_size", None)
        info = time_summary(inference_time, nms_time,
                            n_batches * batch_size if batch_size
                            else n_batches)
        if not data_list:
            return 0.0, 0.0, info + "no detections\n"
        t0 = time.perf_counter()
        coco_gt = self.dataloader.dataset.coco
        if self.testdev:
            with open("./yolox_testdev_2017.json", "w") as f:
                json.dump(data_list, f)
            coco_dt = coco_gt.loadRes("./yolox_testdev_2017.json")
        else:
            coco_dt = coco_gt.loadRes(data_list)
        coco_eval = COCOeval(coco_gt, coco_dt, "bbox")
        coco_eval.evaluate()
        coco_eval.accumulate()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            coco_eval.summarize()
        info += buf.getvalue()
        cat_names = [coco_gt.cats[c]["name"] for c in sorted(coco_gt.cats)]
        if self.per_class_AP:
            info += "per class AP:\n" + per_class_AP_table(
                coco_eval, cat_names) + "\n"
        if self.per_class_AR:
            info += "per class AR:\n" + per_class_AR_table(
                coco_eval, cat_names) + "\n"
        self.timings["cocoeval_s"] = time.perf_counter() - t0
        return coco_eval.stats[0], coco_eval.stats[1], info
