"""Mosaic and MixUp (counterpart of ``eop_tpu/data/mosaic.py``): four
samples tiled around a random centre on a double-size canvas, a random
affine down to the target size, then a 0.5 blend with a jitter-scaled,
maybe flipped donor sample.  ``close_mosaic`` (the no-aug epochs) is the
batch sampler's flag, which each batch carries to the workers.

The draws go through an explicit ``np.random.Generator`` in ``eop_tpu``'s
order; the tile and donor resizes through :func:`resize_host` (one level
of ``cv2.resize``)."""

from __future__ import annotations

import numpy as np

from .augment import random_affine
from .datasets_wrapper import Dataset
from .transforms import PAD_VALUE, resize_host

_PAD = int(PAD_VALUE)


def _span(center: int, extent: int, limit: int, forward: bool):
    """Paste interval and source-crop start for one mosaic axis: forward
    tiles grow from the centre, backward ones end at it; overflow is clipped
    at the canvas and the crop keeps the edge nearest the centre."""
    if forward:
        lo, hi = center, min(center + extent, limit)
        src = 0
    else:
        lo, hi = max(center - extent, 0), center
        src = extent - (hi - lo)
    return lo, hi, src


def get_mosaic_coordinate(mosaic_index, xc, yc, w, h, input_h, input_w):
    """Quadrant 0..3 (TL, TR, BL, BR) around (xc, yc): paste rectangle on the
    2x canvas and the matching source crop, both (x0, y0, x1, y1)."""
    x0, x1, sx = _span(xc, w, 2 * input_w, forward=mosaic_index in (1, 3))
    y0, y1, sy = _span(yc, h, 2 * input_h, forward=mosaic_index in (2, 3))
    return (x0, y0, x1, y1), (sx, sy, sx + (x1 - x0), sy + (y1 - y0))


class MosaicDetection(Dataset):
    """Mosaic / MixUp wrapper around a detection dataset (one with
    ``pull_item``, ``load_anno`` and ``input_dim``)."""

    def __init__(self, dataset, img_size, mosaic=True, preproc=None,
                 degrees=10.0, translate=0.1, mosaic_scale=(0.5, 1.5),
                 mixup_scale=(0.5, 1.5), shear=2.0, enable_mixup=True,
                 mosaic_prob=1.0, mixup_prob=1.0, seed=None):
        super().__init__(img_size, mosaic=mosaic)
        self._dataset = dataset
        self.preproc = preproc
        self.degrees = degrees
        self.translate = translate
        self.scale = mosaic_scale
        self.shear = shear
        self.mixup_scale = mixup_scale
        self.enable_mosaic = mosaic
        self.enable_mixup = enable_mixup
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed):
        self.rng = np.random.default_rng(seed)
        if hasattr(self.preproc, "reseed"):
            self.preproc.reseed(None if seed is None else seed + 1)

    def __len__(self):
        return len(self._dataset)

    def _fit_tile(self, index, input_h, input_w):
        img, labels, _, img_id = self._dataset.pull_item(index)
        h0, w0 = img.shape[:2]
        s = min(input_h / h0, input_w / w0)
        img = resize_host(img, (int(h0 * s), int(w0 * s)))
        return img, labels.copy(), s, img_id

    def _compose_mosaic(self, idx, input_h, input_w):
        """Tile 4 samples around a random centre on a 2x canvas."""
        rng = self.rng
        yc = int(rng.uniform(0.5 * input_h, 1.5 * input_h))
        xc = int(rng.uniform(0.5 * input_w, 1.5 * input_w))
        picks = [idx] + list(rng.integers(0, len(self._dataset), 3))
        canvas = np.full((2 * input_h, 2 * input_w, 3), _PAD, dtype=np.uint8)
        shifted, primary_id = [], None
        for quadrant, index in enumerate(picks):
            tile, labels, s, img_id = self._fit_tile(index, input_h, input_w)
            if primary_id is None:
                primary_id = img_id
            th, tw = tile.shape[:2]
            (x0, y0, x1, y1), (sx0, sy0, sx1, sy1) = get_mosaic_coordinate(
                quadrant, xc, yc, tw, th, input_h, input_w)
            canvas[y0:y1, x0:x1] = tile[sy0:sy1, sx0:sx1]
            if labels.size:
                labels[:, :4] = labels[:, :4] * s + np.tile(
                    [x0 - sx0, y0 - sy0], 2)
                shifted.append(labels)
        if shifted:
            merged = np.concatenate(shifted, axis=0)
            np.clip(merged[:, :4], 0.0, [2 * input_w, 2 * input_h] * 2,
                    out=merged[:, :4])
        else:
            merged = np.zeros((0, 5), dtype=np.float32)
        return canvas, merged, primary_id

    def _pick_donor(self):
        """A random sample with at least one annotation."""
        while True:
            i = int(self.rng.integers(0, len(self._dataset)))
            if len(self._dataset.load_anno(i)) > 0:
                return self._dataset.pull_item(i)

    def mixup(self, origin_img, origin_labels, input_dim):
        """0.5-blend a jitter-scaled (maybe flipped) donor sample cropped at
        random, and append its shifted, clipped boxes."""
        rng = self.rng
        jit = rng.uniform(*self.mixup_scale)
        flip = rng.random() < 0.5
        donor, donor_labels, _, _ = self._pick_donor()
        if donor.ndim != 3:
            raise ValueError(f"mixup donor must be HWC (3-channel), got shape "
                             f"{donor.shape}")
        ratio = jit * min(input_dim[0] / donor.shape[0],
                          input_dim[1] / donor.shape[1])
        fh, fw = int(input_dim[0] * jit), int(input_dim[1] * jit)
        frame = np.full((fh, fw, 3), _PAD, dtype=np.uint8)
        scaled = resize_host(donor, (int(donor.shape[0] * ratio),
                                     int(donor.shape[1] * ratio)))
        frame[: scaled.shape[0], : scaled.shape[1]] = scaled
        if flip:
            frame = frame[:, ::-1]

        th, tw = origin_img.shape[:2]
        stage = frame
        if fh < th or fw < tw:
            stage = np.zeros((max(fh, th), max(fw, tw), 3), dtype=np.uint8)
            stage[:fh, :fw] = frame
        oy = (int(rng.integers(0, stage.shape[0] - th))
              if stage.shape[0] > th else 0)
        ox = (int(rng.integers(0, stage.shape[1] - tw))
              if stage.shape[1] > tw else 0)
        patch = stage[oy: oy + th, ox: ox + tw]

        boxes = donor_labels[:, :4] * ratio
        np.clip(boxes, 0.0, [fw, fh, fw, fh], out=boxes)
        if flip:
            boxes[:, [0, 2]] = fw - boxes[:, [2, 0]]
        boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]] - ox, 0, tw)
        boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]] - oy, 0, th)

        # floor((a + b) / 2): the fp32 0.5 blend truncated to uint8
        blended = ((origin_img.astype(np.uint16) + patch) >> 1).astype(
            np.uint8)
        rows = np.concatenate([boxes, donor_labels[:, 4:5]], axis=1)
        return blended, np.concatenate([origin_labels, rows], axis=0)

    @Dataset.mosaic_getitem
    def __getitem__(self, idx):
        rng = self.rng
        if self.enable_mosaic and rng.random() < self.mosaic_prob:
            input_h, input_w = self._dataset.input_dim[:2]
            img, labels, img_id = self._compose_mosaic(idx, input_h, input_w)
            img, labels = random_affine(
                img, labels, target_size=(input_w, input_h),
                degrees=self.degrees, translate=self.translate,
                scales=self.scale, shear=self.shear, rng=rng)
            if (self.enable_mixup and len(labels)
                    and rng.random() < self.mixup_prob):
                img, labels = self.mixup(img, labels, self.input_dim)
            img, padded = self.preproc(img, labels, self.input_dim)
            return img, padded, (img.shape[1], img.shape[0]), img_id

        self._dataset._input_dim = self.input_dim
        img, label, img_info, img_id = self._dataset.pull_item(idx)
        img, label = self.preproc(img, label, self.input_dim)
        return img, label, img_info, img_id
