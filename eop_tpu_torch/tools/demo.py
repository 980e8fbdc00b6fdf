"""Detection demo: an image, a folder of images or a video to annotated
media, for both families (counterpart of ``tools/demo.py``).

    python -m eop_tpu_torch.tools.demo -f load_eval/yolox_24p_eval.py \
        -p IMAGES [-w CKPT] [--conf 0.25] [--nms T] [--tsize S] \
        [--save-dir DIR] [--int8 [--quant-min-channels 64]] \
        [--device cuda] [key value ...]
    python -m eop_tpu_torch.tools.demo -n yolox-l -w CKPT -p clip.mp4

``-f`` reads an exp file, ``-n`` names an exp (``exps/default/`` or
``yolox_24p_s``); trailing ``key value`` pairs override exp attributes.
``-w`` takes the port's checkpoint, the reference's ``.pth`` or a bare
state_dict (``tools/eval.py::eval_weights``), loaded strictly; without it
the model has seeded random weights.  Each input is letterboxed on the host
(``data/augment.py::preproc``), run at batch 1 through ``exp.get_infer_fn``
(forward, decode, NMS), drawn with ``utils/visualize.py``'s ``vis`` or
``vis_24p`` and written under ``--save-dir`` (default
``output_dir/exp_name/vis_<timestamp>``) with its own name, in its own
format.  Images are read and written without OpenCV (baseline JPEG, PNG,
BMP; ``data/image_io.py``, ``utils/synth.py::write_image``); other inputs,
``.webp`` output and video need cv2 and raise naming OpenCV where it does
not import.  ``--int8`` calibrates on the first 4 images (the first frame
of a video) and runs the eligible convs in int8
(``exp.get_quant_infer_fn``), printing ``int8 PTQ: N convs on the int8
path`` (N the convs quantized, ``ops/quant.py::quantized_keys``; ``eop_tpu``
prints the number of scales calibrated).  Runs on the card; ``--device
cpu`` runs on the CPU.  One line an image (``name: N detections ->
path``), then the images, detections and milliseconds an image.
"""

from __future__ import annotations

import argparse
import os
import time

IMAGE_EXT = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
VIDEO_EXT = (".mp4", ".avi", ".mov", ".mkv", ".webm")
CALIB_IMAGES = 4


def make_parser():
    parser = argparse.ArgumentParser("eop_tpu_torch.tools.demo")
    parser.add_argument("-f", "--exp_file", type=str, default=None)
    parser.add_argument("-n", "--name", type=str, default=None,
                        help="model name (e.g. yolox-s) if no exp file")
    parser.add_argument("-w", "--weights", type=str, default=None,
                        help="the port's checkpoint, the reference's .pth "
                             "or a reference-keyed state_dict")
    parser.add_argument("-p", "--path", type=str, required=True,
                        help="image file, directory of images, or video")
    parser.add_argument("--conf", type=float, default=0.25)
    parser.add_argument("--nms", type=float, default=None)
    parser.add_argument("--tsize", type=int, default=None)
    parser.add_argument("--save-dir", type=str, default=None,
                        help="output dir (default <output_dir>/<exp>/vis_<ts>)")
    parser.add_argument("--int8", action="store_true",
                        help="run the eligible convs in int8 (PTQ calibrated "
                             "on the first inputs)")
    parser.add_argument("--quant-min-channels", type=int, default=64)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="exp overrides: key value ...")
    return parser


def collect_inputs(path: str):
    """-> ("video", file) | ("images", [files])."""
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.lower().endswith(IMAGE_EXT))
        if not files:
            raise FileNotFoundError(f"no images under {path}")
        return "images", files
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} not found")
    if path.lower().endswith(VIDEO_EXT):
        return "video", path
    return "images", [path]


def _opencv(what: str):
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"{what} needs OpenCV (cv2), which is not "
                           "installed") from None
    return cv2


def write_output(path: str, img) -> None:
    """``img`` to ``path`` in the format its extension names: PNG, JPEG
    (quality 95) and BMP without OpenCV, ``.webp`` through cv2."""
    if path.lower().endswith(".webp"):
        _opencv(f"writing {path}").imwrite(path, img)
        return
    from ..utils.synth import write_image

    write_image(path, img)


class Demo:
    """One exp's model and drawing: :meth:`load` the inference function,
    :meth:`detect` a frame, :meth:`draw` its rows.  ``results`` keeps one
    entry an image of :func:`run_images` (``file``, ``rows``, ``ratio``,
    ``path``)."""

    def __init__(self, exp, args):
        from ..exp import Exp24P

        self.exp = exp
        self.args = args
        exp.test_conf = args.conf
        if args.nms is not None:
            exp.nmsthre = args.nms
        if args.tsize is not None:
            exp.test_size = (args.tsize, args.tsize)
        self.is_24p = isinstance(exp, Exp24P)
        self.results = []
        self.save_dir = None

    def load(self, calib_batches):
        from ..ops.quant import quantized_keys
        from .eval import eval_weights

        exp, args = self.exp, self.args
        model = exp.get_model(args.device)
        if args.weights:
            model.load_state_dict(eval_weights(args.weights), strict=True)
        device = next(model.parameters()).device
        if args.int8:
            infer, scales = exp.get_quant_infer_fn(
                model, calib_batches, args.quant_min_channels)
            n = len(quantized_keys(model, scales, args.quant_min_channels))
            print(f"int8 PTQ: {n} convs on the int8 path", flush=True)
            return infer
        return exp.get_infer_fn(model, device)

    def detect(self, infer, frame):
        """BGR frame -> (rows kept above conf, letterbox ratio)."""
        from ..data.augment import preproc

        padded, r = preproc(frame, self.exp.test_size)
        dets = infer(padded[None])
        rows = dets.rows[0][dets.valid[0]].cpu().numpy()
        return rows, r

    def draw(self, frame, rows, ratio):
        from ..data.coco_classes import COCO_CLASSES
        from ..utils.visualize import vis, vis_24p

        names = COCO_CLASSES if self.exp.num_classes == 80 else None
        if self.is_24p:
            # rows: [x, y, r1..r24, obj, cls_conf, cls] in letterbox coords
            return vis_24p(frame, rows, ratio=ratio,
                           conf=self.exp.test_conf, class_names=names)
        # rows: [x1, y1, x2, y2, obj, cls_conf, cls] in letterbox coords
        return vis(frame, rows[:, :4] / ratio, rows[:, 4] * rows[:, 5],
                   rows[:, 6], conf=self.exp.test_conf, class_names=names)


def run_images(demo: Demo, files, save_dir):
    from ..data.augment import preproc
    from ..data.image_io import imread

    # only the calibration images are decoded ahead; the loop streams one
    # image at a time, so a large folder does not fill the host's memory
    calib = [preproc(imread(f), demo.exp.test_size)[0][None]
             for f in files[:CALIB_IMAGES]] if demo.args.int8 else []
    infer = demo.load(calib)
    t0, n_det = time.perf_counter(), 0
    for f in files:
        img = imread(f)
        rows, r = demo.detect(infer, img)
        out = demo.draw(img.copy(), rows, r)
        out_path = os.path.join(save_dir, os.path.basename(f))
        write_output(out_path, out)
        n_det += len(rows)
        demo.results.append({"file": os.path.basename(f), "rows": rows,
                             "ratio": r, "path": out_path})
        print(f"{os.path.basename(f)}: {len(rows)} detections -> {out_path}",
              flush=True)
    dt = time.perf_counter() - t0
    print(f"{len(files)} images, {n_det} detections, "
          f"{dt / len(files) * 1e3:.1f} ms/img incl. compile+IO", flush=True)


def run_video(demo: Demo, src, save_dir):
    cv2 = _opencv(f"reading the video {src}")
    from ..data.augment import preproc

    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video {src}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    # mp4v writes .mp4 containers; every other source goes out as .avi in
    # MJPG, which any OpenCV build encodes
    base = os.path.basename(src)
    stem, ext = os.path.splitext(base)
    if ext.lower() == ".mp4":
        out_path, fourcc = os.path.join(save_dir, base), "mp4v"
    else:
        out_path, fourcc = os.path.join(save_dir, stem + ".avi"), "MJPG"
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cannot open video writer for {out_path} "
                           f"(fourcc {fourcc})")
    ok, first = cap.read()
    if not ok:
        raise RuntimeError(f"empty video {src}")
    infer = demo.load([preproc(first, demo.exp.test_size)[0][None]])
    frames, t0 = 0, time.perf_counter()
    ok, frame = True, first
    while ok:
        rows, r = demo.detect(infer, frame)
        writer.write(demo.draw(frame, rows, r))
        frames += 1
        ok, frame = cap.read()
    cap.release()
    writer.release()
    dt = time.perf_counter() - t0
    print(f"{frames} frames -> {out_path} "
          f"({frames / dt:.1f} fps incl. compile+IO)", flush=True)


def main(argv=None):
    """Runs the demo; returns the :class:`Demo` (``save_dir``,
    ``results``)."""
    args = make_parser().parse_args(argv)
    from ..exp import get_exp

    exp = get_exp(args.exp_file, args.name)
    if args.opts:
        exp.merge(args.opts)
    demo = Demo(exp, args)
    demo.save_dir = args.save_dir or os.path.join(
        exp.output_dir, exp.exp_name,
        time.strftime("vis_%Y_%m_%d_%H_%M_%S", time.localtime()))
    kind, src = collect_inputs(args.path)
    os.makedirs(demo.save_dir, exist_ok=True)
    if kind == "video":
        run_video(demo, src, demo.save_dir)
    else:
        run_images(demo, src, demo.save_dir)
    return demo


if __name__ == "__main__":
    from ..utils.logger import catch

    catch(main)()
