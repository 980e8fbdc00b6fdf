"""The feature-map study on one image (counterpart of
``tools/demo_featuremap.py``), without OpenCV, matplotlib, seaborn or
tabulate:

1. the fixture's objects re-rendered at vertical offsets -100..100 (step
   50) on a gray canvas (the ``none`` sweep);
2. each offset image also warped onto a sector of angle theta for each
   theta of ``--theta-range`` (the ``theta_<t>`` sweeps);
3. the detector (YOLOX over ``--backbone``) run on every image: the FPN
   channel-mean heatmaps with the predicted and GT boxes, each GT box's
   mean activation;
4. each sweep's COCO ``gt.json`` / ``dt.json`` and its AP;
5. the activation table per FPN scale.

    python -m eop_tpu_torch.tools.demo_featuremap -n yolox-l \\
        --backbone resnet --json <fixture.json> [-c <ckpt.pth>] \\
        [--device cpu] [key value ...]

Images are read and written as PNG by the port's own codec; the letterbox
and the warps resize as OpenCV does, bit for bit
(``data/transforms.py::resize_linear``).  Outputs go under the exp's
``output_dir``: ``new_data/<sweep>/`` (images, ``gt.json``) and
``<exp_name>_<backbone>/{vis_res,dt_json}/<sweep>/``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

IMAGE_EXT = [".jpg", ".jpeg", ".webp", ".bmp", ".png"]
DEFAULT_FIXTURE = "/root/reference/yolox/test_data/000000130566.json"
OFFSETS = range(-100, 150, 50)


def make_parser():
    parser = argparse.ArgumentParser("eop_tpu_torch demo_featuremap")
    parser.add_argument("-n", "--name", type=str, default="yolox-l")
    parser.add_argument("-f", "--exp_file", type=str, default=None)
    parser.add_argument("-c", "--ckpt", type=str, default=None,
                        help="a port checkpoint (its EMA weights if any), "
                             "the reference's .pth or a state_dict")
    parser.add_argument("--backbone", type=str, default="darknet",
                        choices=["darknet", "vgg", "resnet", "densenet"])
    parser.add_argument("--json", type=str, default=DEFAULT_FIXTURE,
                        help="single-image COCO fixture json")
    parser.add_argument("--image-dir", type=str, default=None)
    parser.add_argument("--conf", type=float, default=None)
    parser.add_argument("--nms", type=float, default=None)
    parser.add_argument("--tsize", type=int, default=None)
    parser.add_argument("--vis", action="store_true")
    parser.add_argument("--theta-range", type=str, default="30,95,5",
                        help="start,stop,step for the sector sweep")
    parser.add_argument("--reference-parity", action="store_true",
                        help="the reference's forward-splat warp numerics "
                             "(int16 truncation, splat holes) instead of "
                             "the default inverse polar map")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return parser


def letterbox(img: np.ndarray, test_size):
    """The reference's letterbox, float32 ``[*test_size, 3]`` and the
    ratio, resized as OpenCV does."""
    from ..data.transforms import resize_linear

    r = min(test_size[0] / img.shape[0], test_size[1] / img.shape[1])
    canvas = np.full((*test_size, 3), 114, np.uint8)
    scaled = resize_linear(img, (int(img.shape[0] * r),
                                 int(img.shape[1] * r)))
    canvas[:scaled.shape[0], :scaled.shape[1]] = scaled
    return canvas.astype(np.float32), r


class Predictor:
    """Letterbox -> forward (decoded predictions and the FPN maps) ->
    class-agnostic NMS, as the reference's demo predicts."""

    def __init__(self, model, exp, device, cls_names):
        self.model = model
        self.exp = exp
        self.device = device
        self.cls_names = cls_names
        self.confthre = exp.test_conf
        self.nmsthre = exp.nmsthre
        self.test_size = tuple(exp.test_size)

    def inference(self, path: str):
        import torch

        from ..data.image_io import imread
        from ..eval.postprocess import postprocess_bbox
        from ..models.yolox import inference_outputs

        img = imread(path)
        height, width = img.shape[:2]
        padded, ratio = letterbox(img, self.test_size)
        img_info = {"id": 0, "file_name": os.path.basename(path),
                    "height": height, "width": width, "raw_img": img,
                    "ratio": ratio}
        t0 = time.time()
        with torch.inference_mode():
            x = torch.from_numpy(padded[None]).to(self.device).permute(
                0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            head_outs, fpn_outs = self.model(x)
            dets = postprocess_bbox(
                inference_outputs(head_outs).float(), self.exp.num_classes,
                self.confthre, self.nmsthre, class_agnostic=True)
            rows = dets.rows[0][dets.valid[0].bool()].cpu().numpy()
            fpn = [f.float().permute(0, 2, 3, 1).cpu().numpy()
                   for f in fpn_outs[:3]]
        print(f"Infer time: {time.time() - t0:.4f}s")
        return rows, img_info, fpn

    def visual(self, rows, img_info, cls_conf=0.35):
        from ..utils.visualize import vis

        img = img_info["raw_img"]
        if rows is None or len(rows) == 0:
            return img, None, None, None
        bboxes = rows[:, 0:4] / img_info["ratio"]
        cls = rows[:, 6]
        scores = rows[:, 4] * rows[:, 5]
        return (vis(img.copy(), bboxes, scores, cls, cls_conf,
                    self.cls_names), bboxes, scores, cls)


def run_sweep(predictor, data_path, gt_boxes_fm, vis_folder, table):
    """The model over every image of one sweep: (names, boxes, scores,
    classes), the figures and the visualised detections written."""
    from ..utils.synth import write_png
    from .featuremap import create_2d_feature_map

    files = sorted(os.path.join(data_path, f) for f in os.listdir(data_path)
                   if os.path.splitext(f)[1] in IMAGE_EXT)
    names, bboxes, scores, classes = [], [], [], []
    for image_name, gt_box in zip(files, gt_boxes_fm):
        names.append(image_name)
        rows, img_info, fpn = predictor.inference(image_name)
        create_2d_feature_map(
            fpn, rows, gt_box, image_name, table,
            save_path=os.path.join(vis_folder, os.path.basename(
                image_name).replace(".png", "_fm.png")),
            frame=predictor.test_size[0])
        result, bbox, score, cls = predictor.visual(rows, img_info,
                                                    predictor.confthre)
        bboxes.append(bbox)
        scores.append(score)
        classes.append(cls)
        write_png(os.path.join(vis_folder, os.path.basename(image_name)),
                  np.ascontiguousarray(result))
    return names, bboxes, scores, classes


def dt_json_create(names, bboxes, scores, classes, path, id_trans):
    """Detections -> the sweep's COCO ``dt.json``; the image id is the
    offset in the file name."""
    results = []
    for name, bbox, score, cls in zip(names, bboxes, scores, classes):
        if bbox is None or score is None or cls is None:
            continue
        image_id = int(os.path.basename(name).split("_")[1])
        for j in range(len(bbox)):
            xmin, ymin, xmax, ymax = (float(v) for v in bbox[j][:4])
            results.append({
                "image_id": image_id,
                "category_id": id_trans[int(cls[j])],
                "bbox": [xmin, ymin, xmax - xmin, ymax - ymin],
                "score": float(score[j]),
            })
    dt_path = os.path.join(path, "dt.json")
    with open(dt_path, "w", newline="\n") as f:
        f.write(json.dumps(results, indent=1))
    return dt_path


def format_table(rows, headers) -> str:
    """A grid of ``rows`` (a label, then floats to 4 decimals) under
    ``headers``, numbers right-aligned."""
    cells = [[str(r[0])] + [f"{v:.4f}" for v in r[1:]] for r in rows]
    widths = [max(len(str(h)), *(len(c[i]) for c in cells))
              for i, h in enumerate(headers)]

    def line(ch):
        return "+" + "+".join(ch * (w + 2) for w in widths) + "+"

    def row(vals):
        out = [f" {vals[0]:<{widths[0]}} "]
        out += [f" {v:>{w}} " for v, w in zip(vals[1:], widths[1:])]
        return "|" + "|".join(out) + "|"

    lines = [line("-"), row([str(h) for h in headers]), line("=")]
    for c in cells:
        lines += [row(c), line("-")]
    return "\n".join(lines)


def activation_table(table, test_size, thetas):
    """The printed table: for each FPN scale, a row per sweep of each
    offset's first-GT activation."""
    sizes = [test_size // 8, test_size // 16, test_size // 32]
    offsets = ["-100", "-50", "000", "050", "100"]
    out = []
    for idx, size in enumerate(sizes):
        out.append(f"\n===== Feature Map Size: {size}x{size} =====")
        sweeps = [("None", "none")] + [(f"theta_{t}", f"theta_{t}")
                                       for t in thetas]
        rows = [[label] + [table.get(f"offset_{o}_{d}",
                                     [float("nan")] * 3)[idx]
                           for o in offsets]
                for label, d in sweeps]
        out.append(format_table(rows, ["", "-100", "-50", "0", "50",
                                       "100"]))
    return "\n".join(out)


def main(argv=None):
    import torch

    from ..data.coco_classes import COCO_CLASSES
    from ..data.labels24p import COCO_ID2IDX
    from ..exp import get_exp
    from ..utils.model_utils import get_model_info
    from ..utils.synth import write_png
    from .featuremap import (
        ImageDistortion,
        coco_ap,
        get_img_info,
        get_img_mask,
    )

    args = make_parser().parse_args(argv)
    if not os.path.exists(args.json):
        raise FileNotFoundError(f"fixture json {args.json} not found "
                                "(give one with --json)")
    exp = get_exp(args.exp_file, args.name)
    if args.opts:
        exp.merge(args.opts)
    if args.conf is not None:
        exp.test_conf = args.conf
    if args.nms is not None:
        exp.nmsthre = args.nms
    if args.tsize is not None:
        exp.test_size = (args.tsize, args.tsize)
    exp.test_size = tuple(exp.test_size)
    id_trans = {v: k for k, v in COCO_ID2IDX.items()}  # 0-79 -> COCO ids

    table = {}
    new_data_path = os.path.join(exp.output_dir, "new_data")
    run_dir = os.path.join(exp.output_dir, f"{exp.exp_name}_{args.backbone}")
    vis_folder = os.path.join(run_dir, "vis_res")
    dt_folder = os.path.join(run_dir, "dt_json")
    for d in (new_data_path, vis_folder, dt_folder):
        os.makedirs(d, exist_ok=True)
    coco, targets, ori_img, ori_h, ori_w = get_img_info(args.json,
                                                        args.image_dir)

    model = exp.get_model(args.device, backbone_type=args.backbone)
    if args.ckpt:
        from .eval import eval_weights

        model.load_state_dict(eval_weights(args.ckpt), strict=True)
    device = next(model.parameters()).device
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print("Model Summary:", get_model_info(model, exp.test_size))
    predictor = Predictor(model, exp, device, COCO_CLASSES)

    first_cat = targets[0]["category_id"]
    t0, t1, tstep = (int(x) for x in args.theta_range.split(","))
    frame = exp.test_size[0]

    def build_gt_json(data_path, entries):
        after = {"images": [], "annotations": [],
                 "categories": [{"id": cid, "name": str(cid)}
                                for cid in id_trans.values()]}
        for i, (img_id, h, w, bbox) in enumerate(entries, start=1):
            after["images"].append({"height": int(h), "width": int(w),
                                    "id": int(img_id)})
            after["annotations"].append({
                "area": float(bbox[2] * bbox[3]),
                "iscrowd": targets[0].get("iscrowd", 0),
                "image_id": int(img_id),
                "bbox": [float(v) for v in bbox],
                "category_id": first_cat,
                "id": int(i),
            })
        gt_path = os.path.join(data_path, "gt.json")
        with open(gt_path, "w", newline="\n") as f:
            f.write(json.dumps(after, indent=1))
        return gt_path

    def sweep(dis_type, theta=None):
        data_path = os.path.join(new_data_path, dis_type)
        os.makedirs(data_path, exist_ok=True)
        vis_path = os.path.join(vis_folder, dis_type)
        os.makedirs(vis_path, exist_ok=True)
        gt_boxes_fm, entries = [], []
        for offset in OFFSETS:
            canvas, gt_box_fm, gt_box, mask = get_img_mask(
                offset, ori_img, ori_h, ori_w, targets, coco, frame=frame)
            if theta is None:
                out_img = canvas
                bbox = [float(gt_box[0, 0]), float(gt_box[0, 1]),
                        float(gt_box[0, 2] - gt_box[0, 0]),
                        float(gt_box[0, 3] - gt_box[0, 1])]
                gt_boxes_fm.append(gt_box_fm)
            else:
                out_img, label = ImageDistortion().sector_distort(
                    canvas, mask, theta=theta,
                    reference_parity=args.reference_parity)
                if not label:
                    label = [0, 0, 1, 1]
                h, w = out_img.shape[:2]
                r = min(frame / h, frame / w)
                nw, nh = int(w * r), int(h * r)
                gt_boxes_fm.append(np.array([[
                    label[0] / w * nw / frame, label[1] / h * nh / frame,
                    (label[0] + label[2]) / w * nw / frame,
                    (label[1] + label[3]) / h * nh / frame]]))
                bbox = [float(v) for v in label]
            write_png(os.path.join(
                data_path, f"offset_{str(offset).zfill(3)}_{dis_type}.png"),
                out_img)
            entries.append((offset, out_img.shape[0], out_img.shape[1],
                            bbox))
        gt_path = build_gt_json(data_path, entries)
        names, bboxes, scores, classes = run_sweep(
            predictor, data_path, gt_boxes_fm, vis_path, table)
        dt_dir = os.path.join(dt_folder, dis_type)
        os.makedirs(dt_dir, exist_ok=True)
        dt_path = dt_json_create(names, bboxes, scores, classes, dt_dir,
                                 id_trans)
        print(f"{'*' * 24}{dis_type}{'*' * 24}")
        coco_ap(gt_path, dt_path)

    sweep("none")
    thetas = list(range(t0, t1, tstep))
    for theta in thetas:
        sweep(f"theta_{theta}", theta=theta)
    print(activation_table(table, frame, thetas))
    return table


if __name__ == "__main__":
    main()
