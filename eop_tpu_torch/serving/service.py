"""DetectionService: images in, detection dicts out, batched on the device
(counterpart of ``eop_tpu/serving/service.py``), for both families: a bbox
exp's rows become ``bbox`` dicts, a 24p exp's polygons.

Wraps the fused serving function (``exp.get_serving_fn``: uint8 letterbox
+ forward + decode + NMS, or a ``torch.export`` artifact of it from
``tools/export_serving.py``) behind a ``DynamicBatcher``:

    svc = DetectionService.from_exp(exp, model, batch=8, src_hw=(720, 1280))
    svc = DetectionService.from_artifact("serving.pt2")  # export_serving
    dets = svc.detect(frame_bgr)     # any HxW uint8 image, thread-safe
    svc.detect_async(frame_bgr, callback)  # callback(dets, error) later

The serving function takes ``[bucket, *src_hw, 3]`` uint8.  Client images
of another size are letterboxed onto that canvas on the host (pad 114); the
device letterboxes ``src_hw -> test_size`` again.  Both ratios are divided
back out, so returned coordinates are in the posted image's pixel space.

PyTorch runs eagerly, so no bucket needs compiling; warmup runs one call
per bucket before the first request, which builds the kernel library,
initialises the CUDA context and sets up cuDNN for each batch shape, so no
request pays a first-call cost.  A partial batch pads to the smallest
bucket that fits.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.transforms import PAD_VALUE as _PAD_F
from ..data.transforms import letterbox_host
from ..ops.polygon import COS_ANGLES, SIN_ANGLES
from .batcher import DynamicBatcher

PAD_VALUE = int(_PAD_F)
MAX_QUEUE_BYTES = 1 << 30


def _polygon_points(center_xy: np.ndarray, radii: np.ndarray) -> np.ndarray:
    """24 radii -> xy vertices with cos(theta) (never the theta*cos NMS
    quirk)."""
    x = center_xy[0] + radii * COS_ANGLES
    y = center_xy[1] + radii * SIN_ANGLES
    return np.stack([x, y], axis=-1)


class DetectionService:
    """Thread-safe, dynamically batched detection over one serving function.

    ``serve_fn``: ``uint8 [b, *src_hw, 3] -> Detections`` for any bucket
    size ``b``.  ``test_size`` is the model input the function letterboxes
    to — needed to undo that ratio.
    """

    def __init__(self, serve_fn, batch: int, src_hw: Tuple[int, int],
                 test_size: Tuple[int, int],
                 class_names: Optional[Sequence[str]] = None,
                 max_wait_ms: float = 5.0, max_queue: int = 256,
                 buckets: Optional[Sequence[int]] = None):
        self._serve_fn = serve_fn
        self.batch = int(batch)
        self.src_hw = tuple(int(v) for v in src_hw)
        self.test_size = tuple(int(v) for v in test_size)
        self.class_names = list(class_names) if class_names else None
        # padding waste (host->device bytes and device FLOPs) tracks the
        # load: a partial batch pads only to the smallest bucket that fits
        # (an artifact has one shape: its batch is the one bucket)
        self.buckets = (sorted(int(b) for b in buckets) if buckets else
                        [b for b in (1, 2, 4, 8, 16, 32, 64, 128, 256)
                         if b < self.batch] + [self.batch])
        if self.buckets[-1] != self.batch:
            raise ValueError(f"the largest bucket {self.buckets[-1]} is not "
                             f"the batch {self.batch}")
        # the device letterbox ratio (static: both shapes fixed)
        self.dev_ratio = min(self.test_size[0] / self.src_hw[0],
                             self.test_size[1] / self.src_hw[1])
        self._pad_canvas = np.full((1, *self.src_hw, 3), PAD_VALUE, np.uint8)
        self._stats_lock = threading.Lock()
        self._bucket_hits = {b: 0 for b in self.buckets}
        self._device_calls = 0
        for b in self.buckets:
            self._device_call(np.zeros((b, *self.src_hw, 3), np.uint8))
        # each queued request pins a full src_hw canvas on the host, so the
        # queue is bounded in bytes as well as in count
        self._canvas_bytes = int(np.prod(self.src_hw)) * 3
        self._batcher = DynamicBatcher(
            self._run_batch, max_batch=self.batch, max_wait_ms=max_wait_ms,
            max_queue=max_queue, max_queue_cost=MAX_QUEUE_BYTES,
        )

    @classmethod
    def from_exp(cls, exp, model, batch: int,
                 src_hw: Optional[Tuple[int, int]] = None, device=None,
                 class_names=None, quant_scales=None,
                 quant_min_channels: int = 64, **kw) -> "DetectionService":
        """Serve ``exp.get_serving_fn`` over ``model``: int8 where
        ``quant_scales`` is given (with the deploy model of
        ``exp.quantize_for_inference``)."""
        src_hw = tuple(src_hw or exp.test_size)
        serve = exp.get_serving_fn(model, src_hw, device, quant_scales,
                                   quant_min_channels)
        return cls(serve, batch, src_hw, tuple(exp.test_size),
                   class_names=class_names, **kw)

    @classmethod
    def from_artifact(cls, path: str,
                      test_size: Optional[Tuple[int, int]] = None,
                      class_names=None, device=None,
                      **kw) -> "DetectionService":
        """Serve a ``torch.export`` artifact
        (``tools/export_serving.py``) on ``device`` (the card unless
        ``"cpu"``): no model code, checkpoint or exp.  Batch and ``src_hw``
        come from the program's input; ``test_size`` and class names from
        its metadata (pass ``test_size`` only for an artifact without it: a
        wrong one mis-scales every coordinate).  The program has one shape,
        so its batch is the one bucket and every call pads to it."""
        from ..eval.postprocess import Detections
        from ..utils.device import resolve_device
        from ..utils.serving_export import (artifact_input_shape,
                                            load_serving_artifact)

        device = resolve_device(device)
        exported, meta = load_serving_artifact(path, device, with_meta=True)
        if test_size is None:
            if "test_size" not in meta:
                raise ValueError(f"{path} carries no test_size metadata: "
                                 "pass test_size")
            test_size = tuple(meta["test_size"])
        if class_names is None:
            class_names = meta.get("class_names")
        b, h, w, _ = artifact_input_shape(exported)
        program = exported.module()

        def serve(raw_uint8):
            with torch.no_grad():
                x = torch.as_tensor(np.asarray(raw_uint8)).to(device)
                return Detections(*program(x))

        return cls(serve, b, (h, w), test_size, class_names=class_names,
                   buckets=[b], **kw)

    def detect(self, img: np.ndarray,
               timeout: Optional[float] = 30.0) -> List[dict]:
        """Detect on one uint8 HWC (BGR) image of any size; blocks until its
        batch completes.  Coordinates are in the input image's pixels."""
        return self._batcher.submit(self._canvas(img), timeout=timeout,
                                    cost=self._canvas_bytes)

    def detect_async(self, img: np.ndarray, callback) -> None:
        """Non-blocking :meth:`detect`: ``callback(dets, error)`` fires from
        the batcher's dispatcher thread when the batch settles.  Admission
        failures (``QueueFullError`` / ``BatcherClosedError``) raise here
        and never invoke the callback: the event-loop HTTP front end maps
        them to 429 / 503 inline."""
        self._batcher.submit_nowait(self._canvas(img), callback,
                                    cost=self._canvas_bytes)

    def _canvas(self, img: np.ndarray):
        if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
            raise ValueError(f"expected uint8 HWC 3-channel image, got "
                             f"{img.dtype}{list(img.shape)}")
        return letterbox_host(img, self.src_hw)

    def stats(self) -> dict:
        s = self._batcher.stats()
        with self._stats_lock:
            s.update(device_calls=self._device_calls,
                     bucket_hits={str(k): v
                                  for k, v in self._bucket_hits.items() if v})
        s.update(src_hw=list(self.src_hw), test_size=list(self.test_size),
                 buckets=list(self.buckets),
                 class_names=bool(self.class_names))
        return s

    def close(self) -> None:
        self._batcher.close()

    def _device_call(self, canvases: np.ndarray):
        out = self._serve_fn(canvases)
        rows, valid = out.rows.cpu().numpy(), out.valid.cpu().numpy()
        with self._stats_lock:
            self._device_calls += 1
        return rows, valid

    def _run_batch(self, items) -> List[List[dict]]:
        n = len(items)
        bucket = next(b for b in self.buckets if b >= n)
        with self._stats_lock:
            self._bucket_hits[bucket] += 1
        canvases = np.concatenate(
            [c[None] for c, _ in items] + [self._pad_canvas] * (bucket - n))
        rows, valid = self._device_call(canvases)
        return [self._to_dicts(rows[i], valid[i], items[i][1])
                for i in range(n)]

    def _to_dicts(self, rows: np.ndarray, valid: np.ndarray,
                  host_ratio: float) -> List[dict]:
        """Rows -> dicts, by the rows' width: 7 is the bbox family's ``[x1,
        y1, x2, y2, obj, cls_conf, cls]`` (a ``bbox``), 29 the 24p family's
        ``[x, y, r1..r24, obj, cls_conf, cls]`` (``center``, ``radii``,
        ``points``)."""
        ratio = self.dev_ratio * host_ratio
        d = rows.shape[-1]
        if d not in (7, 29):
            raise ValueError(f"detection rows of width {d}: expected 7 "
                             "(bbox) or 29 (24p)")
        out = []
        for row in rows[valid.astype(bool)]:
            obj, cls_conf, cls_id = (float(row[d - 3]), float(row[d - 2]),
                                     int(row[d - 1]))
            det = {
                "class_id": cls_id,
                "score": obj * cls_conf,
                "obj": obj,
                "cls_conf": cls_conf,
            }
            if self.class_names:
                det["class_name"] = self.class_names[cls_id]
            if d == 7:
                det["bbox"] = (row[:4] / ratio).tolist()
            else:
                center = row[:2] / ratio
                radii = row[2:26] / ratio
                det["center"] = center.tolist()
                det["radii"] = radii.tolist()
                det["points"] = _polygon_points(center, radii).tolist()
            out.append(det)
        return out
