"""Synthetic 24-point data.

``synthetic_24p_batch`` (counterpart of ``eop_tpu/utils/synth.py``): one
training batch on the device, the label row layout ``[cls, cx, cy,
24 x (x, y)]`` zero-padded to ``max_labels`` rows, with the same ranges.
The random stream is a ``torch.Generator``'s, not JAX's, so a comparison of
the two packages feeds both the same numpy arrays instead.

``write_24p_dataset``: a seeded dataset on disk in the txt-label layout
(``tools/make_synth_datasets.py``'s recipe), its images BMP content under
``.jpg`` names, written with numpy alone so that a machine without an image
library reads it.  ``LabelOracle``: an ``infer_fn`` that answers with a
dataset's labels, for which an evaluator must give AP 1.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch


def synthetic_24p_batch(generator: torch.Generator, batch: int,
                        size: int = 640, ngt: int = 8, max_labels: int = 50,
                        r_lo: float = 10.0, r_hi: float = 80.0):
    """Returns (images ``[B, S, S, 3]`` f32 in 0..255, labels
    ``[B, max_labels, 51]`` f32 with ``ngt`` valid star-polygon rows), on the
    generator's device."""
    dev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    imgs = uniform((batch, size, size, 3), 0.0, 255.0)
    margin = r_hi + 20.0
    cx = uniform((batch, max_labels, 1), margin, size - margin)
    cy = uniform((batch, max_labels, 1), margin, size - margin)
    r = uniform((batch, max_labels, 24), r_lo, r_hi)
    theta = torch.arange(24, device=dev) * (2 * math.pi / 24)
    pts = torch.stack([cx + r * torch.cos(theta), cy + r * torch.sin(theta)],
                      dim=-1).reshape(batch, max_labels, 48)
    labels = torch.cat([torch.zeros_like(cx), cx, cy, pts], dim=-1)
    keep = torch.arange(max_labels, device=dev)[None, :, None] < ngt
    return imgs, labels * keep


def write_bmp(path: str, img: np.ndarray) -> None:
    """BGR uint8 [H, W, 3] -> a 24-bit uncompressed bottom-up BMP."""
    h, w, _ = img.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[::-1].reshape(h, 3 * w)
    le = lambda v, n: int(v).to_bytes(n, "little", signed=True)  # noqa: E731
    header = (b"BM" + le(54 + rows.size, 4) + le(0, 4) + le(54, 4)
              + le(40, 4) + le(w, 4) + le(h, 4) + le(1, 2) + le(24, 2)
              + le(0, 4) + le(rows.size, 4) + le(2835, 4) + le(2835, 4)
              + le(0, 4) + le(0, 4))
    with open(path, "wb") as f:
        f.write(header + rows.tobytes())


def write_24p_dataset(root: str, n: int, hw, seed: int = 0):
    """``n`` images of ``hw`` with 1-3 discs in class colours on noise,
    labels ``[cls, cx, cy, 24 x (x, y)]`` normalized to the image: images
    ``root/imgs/{i:012}.jpg`` of BMP content, labels
    ``root/labels/{i:012}.txt``.  Returns (image dir, label dir)."""
    h, w = hw
    colors = ((0, 0, 255), (0, 255, 0), (255, 0, 0))
    ang = np.arange(24) * 15.0 * np.pi / 180.0
    rng = np.random.RandomState(seed)
    img_dir, lab_dir = os.path.join(root, "imgs"), os.path.join(root, "labels")
    os.makedirs(img_dir)
    os.makedirs(lab_dir)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        rows = []
        for _ in range(rng.randint(1, 4)):
            cls = rng.randint(0, 3)
            r = rng.uniform(min(h, w) * 0.07, min(h, w) * 0.18)
            cx = rng.uniform(r + 5, w - r - 5)
            cy = rng.uniform(r + 5, h - r - 5)
            img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = colors[cls]
            px, py = cx + r * np.cos(ang), cy + r * np.sin(ang)
            rows.append([cls, cx / w, cy / h]
                        + [v for xy in zip(px / w, py / h) for v in xy])
        write_bmp(os.path.join(img_dir, f"{i:012}.jpg"), img)
        np.savetxt(os.path.join(lab_dir, f"{i:012}.txt"), np.asarray(rows),
                   fmt="%.6f")
    return img_dir, lab_dir


def label_detections(targets, max_det: int = 10):
    """Padded label rows ``[B, max_labels, 51]`` (``TrainTransform24P``'s)
    -> detection rows ``[B, max_det, 29]`` (cx, cy, 24 radii, score 0.9,
    class score 1, class) and their valid mask ``[B, max_det]``, numpy."""
    rows = np.zeros((len(targets), max_det, 29), np.float32)
    valid = np.zeros((len(targets), max_det), bool)
    for i, target in enumerate(targets):
        for k, row in enumerate(r for r in target if r.sum() != 0):
            cx, cy = row[1], row[2]
            rows[i, k, :2] = cx, cy
            rows[i, k, 2:26] = np.hypot(row[3::2] - cx, row[4::2] - cy)
            rows[i, k, 26:29] = 0.9, 1.0, row[0]
            valid[i, k] = True
    return rows, valid


class LabelOracle:
    """``infer_fn`` whose detections are ``dataset``'s labels, in order, on
    ``device``.  Pure in its input: a batch seen again (evaluators run their
    first batch twice) gets the same detections."""

    def __init__(self, dataset, device, max_det: int = 10):
        self.dataset, self.device, self.max_det = dataset, device, max_det
        self.next, self.cache = 0, {}

    def __call__(self, imgs):
        from ..eval.postprocess import Detections

        key = hash(np.asarray(imgs).tobytes())
        if key not in self.cache:
            targets = [self.dataset[self.next + i][1]
                       for i in range(len(imgs))]
            self.next += len(imgs)
            rows, valid = label_detections(targets, self.max_det)
            self.cache[key] = Detections(
                torch.from_numpy(rows).to(self.device),
                torch.from_numpy(valid).to(self.device))
        return self.cache[key]
