"""VOC mAP of the bbox family (counterpart of
``eop_tpu/eval/voc_evaluator.py``): the evaluation loop over the VOC test
loader (:func:`~.coco_evaluator.run_batches`, the COCO evaluator's),
detections rescaled to the raw images and sorted by class into
``all_boxes[class][image]`` rows ``[x1, y1, x2, y2, score]``, then the
dataset's ``evaluate_detections`` (mAP over IoU 0.5:0.95 and mAP50)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .coco_evaluator import run_batches, time_summary


class VOCEvaluator:
    """VOC mAP over a loader of ``VOCDetection`` batches.  ``confthre``
    and ``nmsthre`` are kept as ``eop_tpu`` keeps them; the infer function
    applies the exp's thresholds.  After :meth:`evaluate`, ``timings`` holds
    the loop's seconds and counts, as ``COCOEvaluator``'s."""

    def __init__(self, dataloader, img_size, confthre, nmsthre,
                 num_classes: int):
        self.dataloader = dataloader
        self.img_size = img_size
        self.confthre = confthre
        self.nmsthre = nmsthre
        self.num_classes = num_classes
        self.num_images = len(dataloader.dataset)
        self.timings: dict = {}

    def evaluate(self, infer_fn: Callable,
                 decode_fn: Optional[Callable] = None,
                 distributed: bool = False):
        """Returns (mAP50:95, mAP50, summary); the summary's times are per
        batch.  ``infer_fn``, ``decode_fn`` and ``distributed`` (every
        rank's detections gathered, every rank scores) as in
        ``COCOEvaluator.evaluate``."""
        parts, timings = run_batches(self.dataloader, infer_fn,
                                     self.convert_to_voc_format, decode_fn)
        if distributed:
            from ..parallel.dist import all_gather

            parts = [p for rank_parts in all_gather(parts)
                     for p in rank_parts]
        data_dict = {k: v for part in parts for k, v in part.items()}
        self.timings = timings
        empty = (np.empty((0, 4)), np.empty((0,)), np.empty((0,)))
        all_boxes = [[None] * self.num_images
                     for _ in range(self.num_classes)]
        for img_num in range(self.num_images):
            bboxes, cls, scores = data_dict.get(img_num, empty)
            for j in range(self.num_classes):
                if bboxes.shape[0] == 0:
                    all_boxes[j][img_num] = np.empty([0, 5], dtype=np.float32)
                    continue
                mask_c = cls == j
                all_boxes[j][img_num] = np.hstack(
                    (bboxes[mask_c], scores[mask_c][:, None])).astype(
                        np.float32)
        if distributed:
            # every rank scores, one at a time: the devkit's results and
            # annotation cache files are shared
            from ..parallel.dist import in_rank_order

            mean_ap_5095, mean_ap_50 = in_rank_order(
                lambda: self.dataloader.dataset.evaluate_detections(
                    all_boxes))
        else:
            mean_ap_5095, mean_ap_50 = (
                self.dataloader.dataset.evaluate_detections(all_boxes))
        summary = time_summary(timings["inference_s"], timings["nms_s"],
                               max(timings["batches"], 1), " per batch")
        return mean_ap_5095, mean_ap_50, summary

    def convert_to_voc_format(self, rows: np.ndarray, valid: np.ndarray,
                              info_imgs, ids) -> dict:
        """Rows ``[B, max_det, 7]`` and their valid mask -> {image index:
        (boxes in the raw image's pixels, classes, scores)}."""
        predictions = {}
        img_hs, img_ws = np.asarray(info_imgs[0]), np.asarray(info_imgs[1])
        ids = np.asarray(ids).reshape(-1)
        for b in range(rows.shape[0]):
            r = rows[b][valid[b].astype(bool)]
            scale = min(self.img_size[0] / float(img_hs[b]),
                        self.img_size[1] / float(img_ws[b]))
            predictions[int(ids[b])] = (r[:, 0:4] / scale, r[:, 6].astype(
                np.int64), r[:, 4] * r[:, 5])
        return predictions
