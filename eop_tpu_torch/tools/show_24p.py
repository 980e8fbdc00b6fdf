"""24-point detections drawn on a folder of images (counterpart of
``tools/show_24p.py``).

    python -m eop_tpu_torch.tools.show_24p [-f load_eval/yolox_24p_eval.py \
        | -n yolox_24p_s] [-w CKPT] -p IMAGES [--conf C] [--nms T] \
        [--reference-parity] [--device cuda] [key value ...]

Each ``.jpg``, ``.jpeg``, ``.png`` and ``.bmp`` file of ``-p`` (in sorted
order) is letterboxed (``exp.get_data_input``), run at batch 1 through
``exp.get_infer_fn`` (forward, decode, polygon NMS), drawn with
``utils/visualize.vis_24p`` and written under
``output_dir/exp_name/<timestamp>/`` with its own name, encoded as its
extension names (PNG, baseline JPEG at quality 95, BMP; no OpenCV).  ``-f``
reads an exp file (the default, as ``eop_tpu``'s) and takes precedence
over ``-n``; trailing ``key value`` pairs override exp attributes.  ``-w``
takes the port's checkpoint, the reference's ``.pth`` or a bare state_dict
(``tools/eval.py::eval_weights``), loaded strictly; without it the model
has seeded random weights.  Runs on the card; ``--device cpu`` runs on the
CPU.  One line an image: its detections, the file written and the
milliseconds of read, forward, draw and encode.
"""

from __future__ import annotations

import argparse
import os
import time

DEFAULT_EXP_FILE = "load_eval/yolox_24p_eval.py"
EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def make_parser():
    parser = argparse.ArgumentParser("eop_tpu_torch.tools.show_24p")
    parser.add_argument("-f", "--exp_file", type=str, default=None,
                        help=f"exp file (default {DEFAULT_EXP_FILE} unless "
                             "-n names one)")
    parser.add_argument("-n", "--name", type=str, default=None,
                        help="exp name, e.g. yolox_24p_s")
    parser.add_argument("-w", "--weights", type=str, default=None,
                        help="the port's checkpoint, the reference's .pth "
                             "or a reference-keyed state_dict")
    parser.add_argument("-p", "--path", type=str, default="demo_images",
                        help="directory of images to run on")
    parser.add_argument("--conf", type=float, default=None)
    parser.add_argument("--nms", type=float, default=None)
    parser.add_argument("--reference-parity", action="store_true",
                        help="replicate the reference's theta*cos NMS quirk")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="exp overrides: key value ...")
    return parser


class Evaluator:
    """Runs the folder: ``eval()`` returns the output directory and keeps
    one entry an image in ``results`` (``file``, ``rows``, ``path`` and the
    four ``*_ms``)."""

    def __init__(self, exp, args):
        self.exp = exp
        self.args = args
        if args.conf is not None:
            exp.test_conf = args.conf
        if args.nms is not None:
            exp.nmsthre = args.nms
        if args.reference_parity:
            exp.reference_parity = True
        self.results = []

    def load_model(self):
        from .eval import eval_weights

        model = self.exp.get_model(self.args.device)
        if self.args.weights:
            model.load_state_dict(eval_weights(self.args.weights),
                                  strict=True)
        return model

    def eval(self):
        from ..data.coco_classes import COCO_CLASSES
        from ..utils.synth import write_image
        from ..utils.visualize import vis_24p

        exp = self.exp
        model = self.load_model()
        infer = exp.get_infer_fn(model, next(model.parameters()).device)
        save_dir = os.path.join(
            exp.output_dir, exp.exp_name,
            time.strftime("%Y_%m_%d_%H_%M_%S", time.localtime()))
        os.makedirs(save_dir, exist_ok=True)
        files = sorted(f for f in os.listdir(self.args.path)
                       if f.lower().endswith(EXTENSIONS))
        for fname in files:
            t0 = time.perf_counter()
            imgs, ratio, original = exp.get_data_input(
                os.path.join(self.args.path, fname))
            t1 = time.perf_counter()
            dets = infer(imgs)
            rows = dets.rows[0][dets.valid[0]].cpu().numpy()
            t2 = time.perf_counter()
            out = vis_24p(original.copy(), rows, ratio=ratio,
                          conf=exp.test_conf, class_names=COCO_CLASSES)
            t3 = time.perf_counter()
            out_path = os.path.join(save_dir, fname)
            write_image(out_path, out)
            t4 = time.perf_counter()
            ms = {k: 1e3 * (b - a) for k, a, b in (
                ("read_ms", t0, t1), ("forward_ms", t1, t2),
                ("draw_ms", t2, t3), ("encode_ms", t3, t4))}
            self.results.append({"file": fname, "rows": rows,
                                 "path": out_path, **ms})
            print(f"{fname}: {len(rows)} detections -> {out_path} ("
                  + ", ".join(f"{k[:-3]} {v:.1f} ms" for k, v in ms.items())
                  + ")", flush=True)
        return save_dir


def main(argv=None):
    args = make_parser().parse_args(argv)
    from ..exp import get_exp

    exp_file = args.exp_file or (None if args.name else DEFAULT_EXP_FILE)
    exp = get_exp(exp_file, args.name)
    if args.opts:
        exp.merge(args.opts)
    evaluator = Evaluator(exp, args)
    evaluator.eval()
    return evaluator


if __name__ == "__main__":
    main()
