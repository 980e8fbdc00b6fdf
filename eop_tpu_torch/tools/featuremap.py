"""The feature-map study's pieces (counterpart of
``eop_tpu/tools/featuremap.py``), without OpenCV, matplotlib or seaborn:

* ``get_img_info`` / ``get_img_mask``: the single-image COCO fixture, and
  its objects re-rendered at a vertical offset on a gray canvas;
* ``ImageDistortion.sector_distort``: the image mapped onto an annulus
  sector of angle theta, as an inverse polar map (default) or as the
  reference's forward splat with int16 truncation
  (``reference_parity=True``); the resizes are OpenCV's bilinear bit for
  bit (``data/transforms.py::resize_linear``; the inverse map computes
  only the resized pixels it reads, ``resized_at``), the inverse map's
  sampling its ``remap`` (``data/augment.py::remap_sampled``: bilinear for
  the image with a border of 114, nearest for the mask with 0);
* ``create_2d_feature_map``: the per-scale channel-mean heatmaps of the
  FPN maps and each GT box's mean activation (the study's table), and the
  figure, a numpy-rendered 2 x 3 PNG: the heatmaps under a fixed 256-entry
  colormap, the lower row with predicted boxes in blue and GT in green;
* ``coco_ap``: a sweep's COCO AP through the port's ``COCOeval``.

The arrays and the table are ``eop_tpu``'s; the figure's pixels are not
seaborn's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..data.augment import remap_sampled
from ..data.coco_api import COCO
from ..data.image_io import imread
from ..data.transforms import resize_linear, resized_at
from ..eval.coco_eval import COCOeval
from ..utils.visualize import rectangle


def get_img_info(json_file: str, image_dir: Optional[str] = None):
    """(coco, the first image's annotations, the image BGR uint8, its
    height, its width) of a single-image COCO fixture; the image is looked
    for in ``image_dir``, beside the json, then one directory up."""
    coco = COCO(annotation_file=json_file)
    img_id = sorted(coco.imgs.keys())[0]
    targets = coco.loadAnns(coco.getAnnIds(imgIds=img_id))
    image_name = coco.loadImgs(img_id)[0]["file_name"]
    candidates = [
        os.path.join(image_dir or "", image_name),
        os.path.join(os.path.dirname(json_file), image_name),
        os.path.join(os.path.dirname(os.path.dirname(json_file)),
                     image_name),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            image = imread(path)
            return coco, targets, image, image.shape[0], image.shape[1]
    raise FileNotFoundError(f"fixture image {image_name} not found in "
                            f"{candidates}")


def get_img_mask(offset, ori_img, ori_img_h, ori_img_w, targets, coco,
                 frame: int = 640):
    """The annotated objects re-rendered ``offset`` rows lower on a canvas
    of 114: (canvas, GT boxes normalised to the ``frame`` letterbox, GT
    boxes in pixels, the last object's shifted mask ``[H, W, 3]``)."""
    canvas = np.full((ori_img_h, ori_img_w, 3), 114, dtype=np.uint8)
    gt_box_fm = np.zeros((len(targets), 4))
    gt_box = np.zeros((len(targets), 4))
    r = min(frame / ori_img_h, frame / ori_img_w)
    new_w, new_h = int(ori_img_w * r), int(ori_img_h * r)
    m_shifted = None
    for idx, target in enumerate(targets):
        x, y, w, h = target["bbox"]
        gt_box_fm[idx] = (
            (x / ori_img_w) * new_w / frame,
            ((y + offset) / ori_img_h) * new_h / frame,
            ((x + w) / ori_img_w) * new_w / frame,
            ((y + offset + h) / ori_img_h) * new_h / frame,
        )
        gt_box[idx] = (x, y + offset, x + w, y + offset + h)
        m = coco.annToMask(target)
        m_shift = np.zeros_like(m)
        if offset < 0:
            m_shift[: ori_img_h + offset] = m[-offset:]
        elif offset > 0:
            m_shift[offset:] = m[: ori_img_h - offset]
        else:
            m_shift = m.copy()
        ys, xs = np.nonzero(m)
        ys_dst = ys + offset
        keep = (ys_dst >= 0) & (ys_dst < ori_img_h)
        canvas[ys_dst[keep], xs[keep]] = ori_img[ys[keep], xs[keep]]
        m_shifted = m_shift[..., None].repeat(3, axis=2)
    return canvas, gt_box_fm, gt_box, m_shifted


def _mask_bbox(mask: np.ndarray) -> list:
    """[x, y, w, h] of the first channel's nonzero pixels, [] if none."""
    single = (mask[:, :, 0] if mask.ndim == 3 else mask).astype(bool)
    ys, xs = np.nonzero(single)
    if len(xs) == 0:
        return []
    return [int(xs.min()), int(ys.min()), int(xs.max() - xs.min()),
            int(ys.max() - ys.min())]


class ImageDistortion:
    """The sector (fisheye-like) warp: the apex at the bottom centre of a
    1000-px canvas, the sector symmetric about the vertical, outer radius
    1000, radial depth the outer arc's pixel count times the source's
    aspect.  Both formulations crop to the same int16 bounds."""

    def __init__(self):
        self.draw_temp_size = 1000
        self.sector_length = self.draw_temp_size - 100
        self.draw_resolution = 80

    def _geometry(self, theta: float, scale_hw: float,
                  custom_rows: Optional[int]):
        """(canvas h, canvas w, start angle, arc samples, radial rows)."""
        if not 15 <= theta <= 180:
            raise ValueError(f"theta {theta} is not in 15..180 degrees")
        draw_temp_h = self.draw_temp_size
        draw_temp_w = int(draw_temp_h * np.sin(theta / 2 * np.pi / 180) * 2)
        theta_start = (180 - theta) / 2
        target_w = 165 * self.draw_resolution
        rad = np.linspace(theta_start, theta_start + theta, target_w,
                          True) * np.pi / 180
        arc_x = (draw_temp_h * np.cos(rad)).astype(np.int16)
        arc_y = (draw_temp_h * np.sin(rad)).astype(np.int16)
        arc_len = np.unique(arc_x + 1j * arc_y).shape[0]
        if custom_rows is None:
            target_side = int(
                np.clip(int(arc_len * scale_hw), 0, self.sector_length))
        else:
            if custom_rows > self.sector_length:
                raise ValueError(f"custom_rows {custom_rows} > "
                                 f"{self.sector_length}")
            target_side = custom_rows
        return draw_temp_h, draw_temp_w, theta_start, target_w, target_side

    def _crop_bounds(self, draw_temp_h, draw_temp_w, theta_start, theta,
                     target_w, target_side):
        """The forward splat's crop bounds from its two extreme radial rows,
        with its int16 truncation."""
        rad = np.linspace(theta_start, theta_start + theta, target_w,
                          True) * np.pi / 180
        radii = np.array([float(self.draw_temp_size) - target_side,
                          float(self.draw_temp_size)])[:, None]
        px = (radii * np.cos(rad)).astype(np.int16)
        py = (radii * np.sin(rad)).astype(np.int16)
        x = np.clip((px + draw_temp_w / 2) - 1, 0, draw_temp_w).astype(
            np.int16)
        y = np.clip((draw_temp_h - py) - 1, 0, draw_temp_h).astype(np.int16)
        return int(y.min()), int(y.max()), int(x.min()), int(x.max())

    def sector_distort(self, image, mask, theta: float = 60,
                       custom_rows: Optional[int] = None,
                       reference_parity: bool = False):
        """Warp ``image`` (and ``mask``) onto the sector of angle
        ``theta``: (warped image, the mask's bbox [x, y, w, h] in it, or
        [])."""
        if reference_parity:
            return self._sector_distort_splat(image, mask, theta,
                                              custom_rows)
        img_h, img_w = image.shape[:2]
        (draw_temp_h, draw_temp_w, theta_start, target_w,
         target_side) = self._geometry(theta, img_h / img_w, custom_rows)
        l_b, r_b, t_b, b_b = self._crop_bounds(
            draw_temp_h, draw_temp_w, theta_start, theta, target_w,
            target_side)
        # each destination pixel's polar coordinates about the apex
        # (w/2 - 1, h - 1); the radial index s and arc index c, both source
        # axes reversed as the splat lays them
        ys, xs = np.mgrid[l_b:r_b, t_b:b_b].astype(np.float32)
        xr = xs - (draw_temp_w / 2 - 1)
        yr = (draw_temp_h - 1) - ys
        r = np.hypot(xr, yr)
        ang = np.degrees(np.arctan2(yr, xr))
        r0 = draw_temp_h - target_side
        s = (r - r0) * (target_side - 1) / target_side
        c = (ang - theta_start) * (target_w - 1) / theta
        src_row = (target_side - 1) - s
        src_col = (target_w - 1) - c
        inside = ((r >= r0 - 0.5) & (r <= draw_temp_h + 0.5)
                  & (ang >= theta_start) & (ang <= theta_start + theta))
        # the pixels outside the sector are the border's; the resized
        # source is sampled only where the sector's map reads it
        size = (target_side, target_w)
        map_x = src_col[inside].astype(np.float32)
        map_y = src_row[inside].astype(np.float32)
        new_image = np.full(inside.shape + image.shape[2:], 114, np.uint8)
        new_image[inside] = remap_sampled(
            lambda y, x: resized_at(image, size, y, x), size,
            image.shape[2:], map_x, map_y, 114)
        warped_mask = np.zeros(inside.shape + mask.shape[2:], mask.dtype)
        warped_mask[inside] = remap_sampled(
            lambda y, x: resized_at(mask, size, y, x), size, mask.shape[2:],
            map_x, map_y, 0, nearest=True)
        return new_image, _mask_bbox(warped_mask)

    def _sector_distort_splat(self, image, mask, theta: float = 60,
                              custom_rows: Optional[int] = None):
        """The reference's forward splat: each radial run of source pixels
        rotated by each arc angle, int16-truncated and scattered (the last
        write wins; holes stay gray), then cropped."""
        img_h, img_w, img_c = image.shape
        (draw_temp_h, draw_temp_w, theta_start, target_w,
         target_side) = self._geometry(theta, img_h / img_w, custom_rows)
        draw_img = np.full((draw_temp_h, draw_temp_w, img_c), 114, np.uint8)
        draw_mask = np.zeros((draw_temp_h, draw_temp_w, img_c), np.uint8)
        rad = np.linspace(theta_start, theta_start + theta, target_w,
                          True) * np.pi / 180
        m_rot = np.array([[np.cos(rad), -np.sin(rad)],
                          [np.sin(rad), np.cos(rad)]]).transpose(2, 0, 1)
        r_sector = self.draw_temp_size
        p_xy = np.array([np.linspace(r_sector - target_side, r_sector,
                                     target_side), np.zeros(target_side)])
        # [arc, radial, 2]: each arc angle's run of pixel coordinates
        new_p = np.matmul(m_rot, p_xy).astype(np.int16).transpose(0, 2, 1)
        img_resize = resize_linear(image, (target_side, target_w))
        mask_resize = resize_linear(mask, (target_side, target_w))
        ptx, pty = np.meshgrid(np.arange(target_side), np.arange(target_w))
        new_p[:, :, 0] = np.clip(
            (new_p + draw_temp_w / 2)[:, :, 0] - 1, 0, draw_temp_w)
        new_p[:, :, 1] = np.clip(
            (draw_temp_h - new_p)[:, :, 1] - 1, 0, draw_temp_h)
        ptx = ptx[:, ::-1]
        pty = pty[::-1, :]
        draw_img[new_p[:, :, 1], new_p[:, :, 0]] = img_resize[ptx, pty]
        draw_mask[new_p[:, :, 1], new_p[:, :, 0]] = mask_resize[ptx, pty]
        l_b, r_b = np.min(new_p[:, :, 1]), np.max(new_p[:, :, 1])
        t_b, b_b = np.min(new_p[:, :, 0]), np.max(new_p[:, :, 0])
        new_image = draw_img[l_b:r_b, t_b:b_b].copy()
        return new_image, _mask_bbox(draw_mask[l_b:r_b, t_b:b_b])


def _colormap() -> np.ndarray:
    """A fixed 256-entry BGR colormap, dark purple through red and orange
    to pale yellow (a ramp of the look of seaborn's default heatmap)."""
    t = np.linspace(0.0, 1.0, 256)
    anchors = np.array([0.0, 0.25, 0.5, 0.75, 1.0])
    rgb = np.array([[0.01, 0.02, 0.10], [0.37, 0.09, 0.37],
                    [0.80, 0.12, 0.30], [0.96, 0.52, 0.33],
                    [0.98, 0.92, 0.84]])
    cols = [np.interp(t, anchors, rgb[:, k]) for k in (2, 1, 0)]
    return np.rint(np.stack(cols, 1) * 255).astype(np.uint8)


COLORMAP = _colormap()
BLUE, GREEN = (255, 0, 0), (0, 160, 0)


def heatmap_image(values: np.ndarray, cell: int) -> np.ndarray:
    """A ``[S, S]`` map -> uint8 BGR ``[cell, cell, 3]``: normalised to its
    own min..max, coloured by :data:`COLORMAP`, nearest-upscaled."""
    v = np.asarray(values, np.float64)
    lo, hi = np.nanmin(v), np.nanmax(v)
    idx = np.zeros(v.shape, np.int64) if not hi > lo else np.clip(
        ((v - lo) / (hi - lo) * 255).round(), 0, 255).astype(np.int64)
    rows = np.arange(cell) * v.shape[0] // cell
    cols = np.arange(cell) * v.shape[1] // cell
    return COLORMAP[idx[rows][:, cols]]


def create_2d_feature_map(fpn_outs, pred_rows, gt_box_fm, image_name,
                          table: Dict[str, List[float]],
                          save_path: Optional[str] = None,
                          frame: int = 640, cell: int = 320):
    """The channel-mean heatmap of each of the first three FPN maps
    (``[1, H, W, C]`` NHWC arrays at strides 8 / 16 / 32) and each GT box's
    mean activation on it, appended to ``table`` under the image's stem
    (three scales, GT by GT).  ``pred_rows``: ``[N, >=4]`` xyxy in the
    ``frame`` (model input) frame; ``gt_box_fm``: ``[G, 4]`` normalised to
    it.  With ``save_path`` the 2 x 3 figure is written as a PNG.
    Returns this image's activations."""
    from ..utils.synth import encode_png

    if pred_rows is None or len(pred_rows) == 0:
        pred_rows = np.zeros((1, 7))
    pred_box = np.asarray(pred_rows, np.float64)[:, :4] / frame
    gt = np.asarray(gt_box_fm, np.float64).reshape(-1, 4)
    results, top, bottom = [], [], []
    for idx in range(3):
        fpn_np = np.asarray(fpn_outs[idx])[0]
        fpn_sum = fpn_np.mean(axis=-1)
        size = fpn_np.shape[0]
        heat = heatmap_image(fpn_sum, cell)
        boxed = heat.copy()
        for boxes, color in ((pred_box, BLUE), (gt, GREEN)):
            for cur in boxes:
                x0, y0, x1, y1 = (v * cell for v in cur)
                if np.isfinite([x0, y0, x1, y1]).all():
                    rectangle(boxed, (round(x0), round(y0)),
                              (round(x1), round(y1)), color)
        top.append(heat)
        bottom.append(boxed)
        for g in gt:
            xmin, ymin, xmax, ymax = g * size
            gt_pixel = fpn_sum[int(ymin):int(ymax), int(xmin):int(xmax)]
            denom = gt_pixel.shape[0] * gt_pixel.shape[1]
            results.append(float(gt_pixel.sum() / denom) if denom
                           else float("nan"))
    table[os.path.basename(image_name).split(".")[0]] = results
    if save_path:
        gap = np.full((cell, 8, 3), 255, np.uint8)
        rows = [np.concatenate([r[0], gap, r[1], gap, r[2]], 1)
                for r in (top, bottom)]
        sep = np.full((8, rows[0].shape[1], 3), 255, np.uint8)
        with open(save_path, "wb") as f:
            f.write(encode_png(np.concatenate([rows[0], sep, rows[1]], 0)))
    return results


def coco_ap(gt_json_path: str, dt_json_path: str):
    """COCO box AP of one sweep (prints the summary; 12 stats)."""
    coco_gt = COCO(gt_json_path)
    with open(dt_json_path) as f:
        dts = json.load(f)
    if not dts:
        print("no detections; AP = 0")
        return np.zeros(12)
    e = COCOeval(coco_gt, coco_gt.loadRes(dts), "bbox")
    e.evaluate()
    e.accumulate()
    e.summarize()
    return e.stats
