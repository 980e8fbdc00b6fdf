"""Small synthetic datasets for end-to-end training runs (counterpart of
``tools/make_synth_datasets.py``), written without OpenCV.

Two flavours, both learnable (the class is the colour):

* ``coco``: coloured rectangles and ellipses on dark noise -> COCO json
  (``train2017`` + ``val2017``), for ``tools.train`` / ``tools.eval``;
* ``24p``: coloured discs -> one txt label file an image in the 24-point
  format ``[cls, cx, cy, 24 x (x, y)]`` (normalized), for
  ``tools.train_24p``.

    python -m eop_tpu_torch.tools.make_synth_datasets coco --out DIR
    python -m eop_tpu_torch.tools.make_synth_datasets 24p --out DIR \
        [--size 256] [--n 64] [--n-val 16] [--seed 0]

The random draws, the annotations and the labels are ``eop_tpu``'s, byte
for byte; the shapes are drawn as ``cv2.fillPoly``, ``cv2.rectangle`` and
``cv2.circle`` draw them (``data/coco_api.py::fill_poly``,
``utils/visualize.py::circle``) and the images are written as baseline
JPEG, quality 95, 4:2:0 (``utils/synth.py::write_jpeg``, libjpeg's integer
transform; ``cv2.imwrite``'s default quality and sampling).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.coco_api import fill_poly
from ..utils.synth import write_jpeg
from ..utils.visualize import circle

COLORS = {0: (220, 40, 40), 1: (40, 220, 40), 2: (40, 40, 220)}


def draw_coco_image(rng: np.random.RandomState, size: int, img_id: int):
    """One image of :func:`make_coco` and its annotations (ids from 0, set
    by the caller), drawing from ``rng`` in ``eop_tpu``'s order."""
    img = rng.randint(0, 60, (size, size, 3)).astype(np.uint8)
    annotations = []
    for _ in range(rng.randint(1, 4)):
        bw, bh = rng.randint(30, int(size * 0.35), 2)
        x = rng.randint(0, size - bw)
        y = rng.randint(0, size - bh)
        cat = int(rng.choice([1, 2, 3]))
        # the shape as a polygon too, so that mask readers (the 24p label
        # generator, the feature-map study) work on this set; rectangles
        # for categories 1 and 3, an ellipse for 2
        if cat == 2:
            cx, cy = x + bw / 2.0, y + bh / 2.0
            ang = np.linspace(0, 2 * np.pi, 20, endpoint=False)
            px = cx + (bw / 2.0) * np.cos(ang)
            py = cy + (bh / 2.0) * np.sin(ang)
            pts = np.stack([px, py], 1)
            fill_poly(img, [pts.astype(np.int32)], COLORS[cat - 1])
            seg = [float(v) for v in pts.reshape(-1)]
            area = float(np.pi * (bw / 2.0) * (bh / 2.0))
        else:
            # cv2.rectangle(..., -1): both corners inclusive
            img[y:y + bh + 1, x:x + bw + 1] = COLORS[cat - 1]
            seg = [float(x), float(y), float(x + bw), float(y),
                   float(x + bw), float(y + bh), float(x), float(y + bh)]
            area = float(bw * bh)
        annotations.append({
            "id": 0, "image_id": img_id, "category_id": cat,
            "bbox": [float(x), float(y), float(bw), float(bh)],
            "area": area, "iscrowd": 0,
            "segmentation": [seg],
        })
    return img, annotations


def make_coco(root: str, size: int, n_train: int, n_val: int, seed: int):
    def split(name, n, s):
        rng = np.random.RandomState(s)
        os.makedirs(f"{root}/{name}", exist_ok=True)
        os.makedirs(f"{root}/annotations", exist_ok=True)
        images, annotations = [], []
        for img_id in range(1, n + 1):
            img, anns = draw_coco_image(rng, size, img_id)
            for ann in anns:
                ann["id"] = len(annotations) + 1
                annotations.append(ann)
            fname = f"{img_id:012}.jpg"
            write_jpeg(f"{root}/{name}/{fname}", img)
            images.append({"id": img_id, "width": size, "height": size,
                           "file_name": fname})
        cats = [{"id": i + 1, "name": n}
                for i, n in enumerate(("red", "green", "blue"))]
        with open(f"{root}/annotations/instances_{name}.json", "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": cats}, f)

    split("train2017", n_train, seed)
    split("val2017", n_val, seed + 1)
    print(f"coco: {n_train} train + {n_val} val images under {root}")


def draw_24p_image(rng: np.random.RandomState, size: int):
    """One image of :func:`make_24p` and its label rows, drawing from
    ``rng`` in ``eop_tpu``'s order."""
    ang = np.arange(24) * 15.0 * np.pi / 180.0
    img = rng.randint(0, 60, (size, size, 3)).astype(np.uint8)
    rows = []
    for _ in range(rng.randint(1, 4)):
        cls = rng.randint(0, 3)
        r = rng.uniform(size * 0.07, size * 0.18)
        cx = rng.uniform(r + 5, size - r - 5)
        cy = rng.uniform(r + 5, size - r - 5)
        circle(img, (int(cx), int(cy)), int(r), COLORS[cls], -1)
        px, py = cx + r * np.cos(ang), cy + r * np.sin(ang)
        rows.append(
            [cls, cx / size, cy / size]
            + [v for xy in zip(px / size, py / size) for v in xy])
    return img, np.asarray(rows, float)


def make_24p(root: str, size: int, n: int, seed: int):
    rng = np.random.RandomState(seed)
    img_dir, lab_dir = f"{root}/imgs", f"{root}/labels"
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    for i in range(n):
        img, rows = draw_24p_image(rng, size)
        write_jpeg(f"{img_dir}/{i:04d}.jpg", img)
        np.savetxt(f"{lab_dir}/{i:04d}.txt", rows, fmt="%.6f")
    print(f"24p: {n} images under {img_dir} + labels under {lab_dir}")


def make_parser():
    ap = argparse.ArgumentParser("eop_tpu_torch.tools.make_synth_datasets")
    ap.add_argument("flavor", choices=["coco", "24p"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--n-val", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.flavor == "coco":
        make_coco(args.out, args.size, args.n, args.n_val, args.seed)
    else:
        make_24p(args.out, args.size, args.n, args.seed)


if __name__ == "__main__":
    main()
