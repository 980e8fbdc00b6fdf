"""24-point label generation: COCO instance masks ray-cast into ``[cls, cx,
cy, 24 x (x, y)]`` rows (counterpart of ``eop_tpu/data/labels24p.py``).

For every non-crowd annotation of area 1 or more, its mask is rendered
(``data/coco_api.py``: ``fill_poly`` for polygons, the RLE codec), 24 rays
are cast from its box centre at 15 degree steps, the first pixel off the
mask along each ray is the boundary point, and a label whose 24-point
convex hull has an area outside ``[0.5, 1.5]`` times the annotated area is
dropped (``data/geometry.py``: ``convex_hull``, ``contour_area``).  Rows are
saved normalised, "Cord" (51 columns, the form ``COCO24PDataset`` reads) or
"Radius" (27), one txt file an image.

``ray_cast_24`` keeps the reference's numeric quirks: 0.2 px ray steps
truncated with ``astype(np.int16)``, the de-duplication by ``np.unique`` on
a complex key (sorted by real part, then imaginary), the one-pixel window
offset, the nearest survivor.  ``COCO_ID2IDX`` maps the published 2017 ids
1..90 (ten retired) to the contiguous 0..79 training ids.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .coco_api import COCO
from .geometry import contour_area, convex_hull

# ids removed before the 2017 release; the contiguous id is the rank among
# the survivors
_RETIRED_COCO_IDS = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}
COCO_ID2IDX = {
    cid: idx
    for idx, cid in enumerate(
        c for c in range(1, 91) if c not in _RETIRED_COCO_IDS)
}


def ray_cast_24(center_x: float, center_y: float,
                mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """24 boundary points and their radii from ``(center_x, center_y)``
    over ``mask`` [h, w]: (int points [24, 2], float radii [24]).

    Along each ray (0, 15, ..., 345 degrees) the 0.2 px steps are truncated
    to int16 offsets and de-duplicated; a step survives inside the window
    of the image and a one-pixel border, off the mask; the survivor nearest
    the centre, in window coordinates (one pixel past the image's), is the
    point.  A ray with no survivor falls back to the centre, radius 0."""
    img_h, img_w = mask.shape[:2]
    max_line = int(np.hypot(img_h, img_w))
    steps = np.arange(0, max_line, 0.2)
    base = np.stack([steps, np.zeros_like(steps)])  # [2, L]

    cords, radii = [], []
    for rot_time in range(24):
        theta = rot_time * 15 * np.pi / 180
        m_rot = np.array([[np.cos(theta), -np.sin(theta)],
                          [np.sin(theta), np.cos(theta)]])
        pts = (m_rot @ base).astype(np.int16)
        _, idx = np.unique(pts[0, :] + pts[1, :] * 1j, return_index=True)
        pts = pts[:, idx]
        # the integer offset's truncation then the centre's floor: the
        # pixel the step lands on
        xi = np.floor(pts[0, :] + center_x).astype(np.int64)
        yi = np.floor(pts[1, :] + center_y).astype(np.int64)
        in_window = (xi >= -1) & (xi <= img_w) & (yi >= -1) & (yi <= img_h)
        on_mask = np.zeros_like(in_window)
        inside = (xi >= 0) & (xi < img_w) & (yi >= 0) & (yi < img_h)
        on_mask[inside] = mask[yi[inside], xi[inside]] != 0
        alive = in_window & ~on_mask
        if not alive.any():
            cords.append(np.array([int(center_x), int(center_y)]))
            radii.append(0.0)
            continue
        wx, wy = xi[alive] + 1, yi[alive] + 1
        dist = np.sqrt((wx - center_x) ** 2 + (wy - center_y) ** 2)
        k = int(np.argmin(dist))
        cords.append(np.array([np.clip(wx[k], 0, img_w),
                               np.clip(wy[k], 0, img_h)]))
        radii.append(float(dist[k]))
    return np.array(cords), np.array(radii)


class Polygon24:
    """The label generator over one COCO json: ``process()`` then
    ``save()``."""

    def __init__(self, json_label_path: str, image_data_path: str,
                 output_path: str, mode: str = "Cord"):
        if mode not in ("Cord", "Radius"):
            raise ValueError(f"mode {mode!r}: 'Cord' or 'Radius'")
        self.mode = mode
        self.json_label_pth = json_label_path
        self.image_data_pth = image_data_path
        self.new_label_pth = output_path
        self.coco = COCO(json_label_path)
        self.label_dict_cord24: Dict[str, list] = {}
        self.label_dict_radius: Dict[str, list] = {}

    def process(self, area_t_low=0.5, area_t_high=1.5, progress=False):
        """Ray-cast every usable annotation whose image file exists
        (``{image_id:012}.jpg``); sizes come from the index, no image is
        read.  ``progress`` prints the count every 1000 annotations."""
        anno_info = self.coco.dataset.get("annotations", [])
        sizes = {}
        for n, anno in enumerate(anno_info, 1):
            if progress and (n % 1000 == 0 or n == len(anno_info)):
                print(f"{n}/{len(anno_info)} annotations", flush=True)
            name = str(anno["image_id"]).zfill(12)
            self.label_dict_cord24.setdefault(name, [])
            self.label_dict_radius.setdefault(name, [])
            if anno.get("iscrowd", 0):
                continue
            label_area = anno["area"]
            if label_area < 1:
                continue
            label_id = np.array([COCO_ID2IDX[int(anno["category_id"])]])
            if name not in sizes:
                if not os.path.exists(Path(self.image_data_pth)
                                      / f"{name}.jpg"):
                    continue
                info = self.coco.imgs[anno["image_id"]]
                sizes[name] = int(info["height"]), int(info["width"])
            img_h, img_w = sizes[name]
            img_diag = np.hypot(img_h, img_w)
            bbox = np.asarray(anno["bbox"], dtype=np.float64)
            obj_x, obj_y = bbox[:2] + bbox[2:4] / 2
            cur_24p, cur_24r = ray_cast_24(obj_x, obj_y,
                                           self.coco.annToMask(anno))
            cur_24r = cur_24r / img_diag
            hull_area = contour_area(convex_hull(cur_24p.astype(np.int32)))
            if (hull_area <= label_area * area_t_low
                    or hull_area >= label_area * area_t_high):
                continue
            obj_cord = np.array([obj_x / img_w, obj_y / img_h])
            flat = cur_24p.reshape(-1).astype(np.float32)
            flat[0::2] = flat[0::2] / img_w
            flat[1::2] = flat[1::2] / img_h
            self.label_dict_cord24[name].append(
                np.concatenate((label_id, obj_cord, flat)))
            self.label_dict_radius[name].append(
                np.concatenate((label_id, obj_cord, cur_24r)))
        return self.label_dict_cord24, self.label_dict_radius

    def save(self):
        """One txt file an image under ``output_path`` (an empty file for an
        image without rows)."""
        os.makedirs(self.new_label_pth, exist_ok=True)
        if self.mode == "Cord":
            label_dict = self.label_dict_cord24
            fmt = ["%d"] + ["%0.4f"] * 50
        else:
            label_dict = self.label_dict_radius
            fmt = ["%d"] + ["%0.4f"] * 26
        for name, rows in label_dict.items():
            txt_pth = Path(self.new_label_pth) / f"{name}.txt"
            arr = np.array(rows)
            if arr.shape[0]:
                np.savetxt(str(txt_pth), arr, fmt=fmt)
            else:
                np.savetxt(str(txt_pth), arr)
