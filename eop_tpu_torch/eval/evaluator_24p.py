"""24-point detector evaluation: COCO AP over the polygons' enclosing boxes
(counterpart of ``eop_tpu/eval/evaluator_24p.py``).

Ground truth comes from the 24p txt labels (polygon -> enclosing rectangle,
the geometry the 24p NMS uses), detections from the fixed-capacity polygon
postprocess, AP from the port's COCOeval.  AP50 is the "COCO-24p AP50" the
reference paper reports.
"""

from __future__ import annotations

import contextlib
import io
import os
import time
from typing import Callable

import numpy as np

from ..data.coco_api import COCO
from ..data.image_io import image_size
from ..ops.polygon import COS_ANGLES, SIN_ANGLES
from .coco_eval import COCOeval


def polygon_rows_to_xyxy(rows: np.ndarray) -> np.ndarray:
    """[N, >=26] rows (cx, cy, 24 radii) -> enclosing [N, 4] xyxy."""
    cx, cy = rows[:, 0], rows[:, 1]
    radii = rows[:, 2:26]
    xs = cx[:, None] + radii * COS_ANGLES
    ys = cy[:, None] + radii * SIN_ANGLES
    return np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)


class Evaluator24P:
    """COCO-style AP for the 24p detector over its txt-label dataset.

    After :meth:`evaluate`, ``timings`` holds the seconds spent waiting for
    the loader (and for its first batch, which includes starting its
    workers), in the timed inference calls and in COCOeval, with the image,
    batch and detection counts.
    """

    def __init__(self, dataloader, img_size, num_classes: int):
        self.dataloader = dataloader
        self.img_size = img_size
        self.num_classes = num_classes
        self.timings: dict = {}
        self._gt = self._build_gt()

    def _build_gt(self) -> COCO:
        """A COCO index of the dataset's normalized 24p labels, in pixels of
        the raw images (their sizes read from the file headers)."""
        ds = self.dataloader.dataset
        images, annotations = [], []
        ann_id = 1
        for idx in range(len(ds)):
            img_name = ds.image_list[idx]
            key = img_name.split(".")[0]
            img_id = int(key)
            ori_w, ori_h = image_size(os.path.join(ds.data_dir, img_name))
            images.append({"id": img_id, "width": int(ori_w),
                           "height": int(ori_h), "file_name": img_name})
            rows = ds.coco24p_dict[key]
            rows = rows.reshape(-1, rows.shape[-1]) if rows.size else rows
            for row in rows:
                cls = int(row[0])
                pts = row[1:].copy()
                pts[0::2] *= ori_w
                pts[1::2] *= ori_h
                xs, ys = pts[2::2], pts[3::2]  # the 24 polygon vertices
                x1, y1 = float(xs.min()), float(ys.min())
                x2, y2 = float(xs.max()), float(ys.max())
                annotations.append({
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": cls,
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "area": float((x2 - x1) * (y2 - y1)),
                    "iscrowd": 0,
                })
                ann_id += 1
        gt = COCO()
        gt.dataset = {
            "images": images,
            "annotations": annotations,
            "categories": [{"id": c, "name": str(c)}
                           for c in range(self.num_classes)],
        }
        gt.createIndex()
        return gt

    def evaluate(self, infer_fn: Callable):
        """Returns (ap50_95, ap50, summary).

        ``infer_fn`` maps a letterboxed batch to ``Detections`` and must be
        pure: the first batch runs once more, untimed, before its timed
        call, which keeps first launches and library autotuning out of the
        timer.  Each timed call ends in the host copy of its detections,
        which waits for the device.
        """
        dets_json = []
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
            rows = dets.rows.cpu().numpy()
            valid = dets.valid.cpu().numpy()
            inference_time += time.perf_counter() - start
            n_batches += 1
            n_images += rows.shape[0]
            ids = np.asarray(ids).reshape(-1)
            img_hs, img_ws = np.asarray(info_imgs[0]), np.asarray(info_imgs[1])
            for b in range(rows.shape[0]):
                r = rows[b][valid[b].astype(bool)]
                if not len(r):
                    continue
                scale = min(self.img_size[0] / float(img_hs[b]),
                            self.img_size[1] / float(img_ws[b]))
                boxes = polygon_rows_to_xyxy(r) / scale
                scores = r[:, 26] * r[:, 27]
                for box, score, cls in zip(boxes, scores, r[:, 28]):
                    x1, y1, x2, y2 = (float(v) for v in box)
                    dets_json.append({
                        "image_id": int(ids[b]),
                        "category_id": int(cls),
                        "bbox": [x1, y1, x2 - x1, y2 - y1],
                        "score": float(score),
                    })

        self.timings = {"batches": n_batches, "images": n_images,
                        "detections": len(dets_json),
                        "inference_s": inference_time,
                        "data_wait_s": data_wait,
                        "first_batch_wait_s": first_wait, "cocoeval_s": 0.0}
        info = (f"Average inference time: "
                f"{1000 * inference_time / max(n_batches, 1):.2f} ms/batch "
                "(NMS fused)\n")
        if not dets_json:
            return 0.0, 0.0, info + "no detections\n"
        t0 = time.perf_counter()
        coco_dt = self._gt.loadRes(dets_json)
        e = COCOeval(self._gt, coco_dt, "bbox")
        e.evaluate()
        e.accumulate()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            e.summarize()
        self.timings["cocoeval_s"] = time.perf_counter() - t0
        return e.stats[0], e.stats[1], info + buf.getvalue()
