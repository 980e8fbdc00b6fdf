"""COCO box AP of the bbox family (counterpart of
``eop_tpu/eval/coco_evaluator.py``): the batched evaluation loop over the
val loader, detections rescaled to the raw images as COCO result dicts,
the port's COCOeval, and the per-class AP / AR tables as markdown (the same
text ``tabulate``'s ``pipe`` format prints, without the package)."""

from __future__ import annotations

import contextlib
import io
import time
from typing import Callable, Dict, List, Sequence

import numpy as np

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


class COCOEvaluator:
    """COCO box AP over a val loader of ``COCODataset`` batches.

    After :meth:`evaluate`, ``timings`` holds the seconds spent waiting for
    the loader (and for its first batch, which includes starting its
    workers), in the timed inference calls and in COCOeval, with the image,
    batch and detection counts.
    """

    def __init__(self, dataloader, img_size, num_classes: int,
                 per_class_AP: bool = False, per_class_AR: bool = False):
        self.dataloader = dataloader
        self.img_size = img_size
        self.num_classes = num_classes
        self.per_class_AP = per_class_AP
        self.per_class_AR = per_class_AR
        self.timings: dict = {}

    def evaluate(self, infer_fn: Callable):
        """Returns (ap50_95, ap50, summary).

        ``infer_fn`` maps a letterboxed batch to ``Detections`` and must be
        pure: the first batch runs once more, untimed, before its timed
        call.  Each timed call ends in the host copy of its detections,
        which waits for the device."""
        data_list: List[dict] = []
        inference_time = data_wait = first_wait = 0.0
        n_batches = n_images = 0
        batches = iter(self.dataloader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            data_wait += time.perf_counter() - t0
            if batch is None:
                break
            imgs, _, info_imgs, ids = batch
            if n_batches == 0:
                first_wait = data_wait
                infer_fn(imgs).rows.cpu()
            start = time.perf_counter()
            dets = infer_fn(imgs)
            rows = dets.rows.float().cpu().numpy()
            valid = dets.valid.cpu().numpy()
            inference_time += time.perf_counter() - start
            n_batches += 1
            n_images += rows.shape[0]
            data_list.extend(self.convert_to_coco_format(rows, valid,
                                                         info_imgs, ids))
        self.timings = {"batches": n_batches, "images": n_images,
                        "detections": len(data_list),
                        "inference_s": inference_time,
                        "data_wait_s": data_wait,
                        "first_batch_wait_s": first_wait, "cocoeval_s": 0.0}
        return self.evaluate_prediction(data_list, inference_time,
                                        max(n_batches, 1))

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
                            inference_time: float = 0.0,
                            n_batches: int = 1):
        """COCO result dicts -> COCOeval -> (ap50_95, ap50, summary)."""
        info = (f"Average inference time: "
                f"{1000 * inference_time / n_batches:.2f} ms/batch "
                "(NMS fused)\n")
        if not data_list:
            return 0.0, 0.0, info + "no detections\n"
        t0 = time.perf_counter()
        coco_gt = self.dataloader.dataset.coco
        coco_eval = COCOeval(coco_gt, coco_gt.loadRes(data_list), "bbox")
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
