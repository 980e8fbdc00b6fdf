"""AP of a checkpoint (counterpart of ``tools/eval.py``): the bbox family
over a COCO-format directory (COCO AP) or a VOC devkit (VOC mAP), the 24p
family over image and label files (COCO-24p AP).

    python -m eop_tpu_torch.tools.eval -n yolox-l -c CKPT -b 8 \
        --data-dir COCO_DIR [--per-class-ap] [--testdev] [--legacy] \
        [--device cuda] [key value ...]
    python -m eop_tpu_torch.tools.eval \
        -f exps/example/yolox_voc/yolox_voc_s.py -c CKPT -b 8 \
        --data-dir ROOT_OF_VOCDEVKIT
    python -m eop_tpu_torch.tools.eval -f load_eval/yolox_24p_eval.py \
        -c CKPT -b 8 --data-dir IMGS --label-dir LABELS [--device cuda] \
        [key value ...]

``-c`` takes the port's own checkpoint (``train/checkpoint.py``; its EMA
weights where it has them, as the trainer evaluates) or a state_dict in the
reference's key names; either loads strictly.  Without ``-c`` the model has
seeded random weights.  ``--testdev`` scores ``test_ann`` (``test2017/``)
through ``./yolox_testdev_2017.json``, ``--legacy`` feeds the model RGB in
0..1 with ImageNet normalisation; both reach only an exp whose
``get_evaluator`` takes them (the bbox family's; the 24p family's takes
neither, and they are dropped).  Prints the summary (its first line the
average forward, NMS and inference times: the NMS time is estimated from
extra forward-and-decode calls on the first batch), then ``AP50:95 = x
AP50 = y``.  Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import inspect


def make_parser():
    parser = argparse.ArgumentParser("eop_tpu_torch.tools.eval")
    parser.add_argument("-n", "--name", type=str, default=None)
    parser.add_argument("-f", "--exp_file", type=str, default=None)
    parser.add_argument("-c", "--ckpt", type=str, default=None,
                        help="the port's checkpoint or a reference-keyed "
                             "state_dict (.pth)")
    parser.add_argument("-b", "--batch_size", type=int, default=64)
    parser.add_argument("--conf", type=float, default=None)
    parser.add_argument("--nms", type=float, default=None)
    parser.add_argument("--tsize", type=int, default=None)
    parser.add_argument("--data-dir", type=str, default=None)
    parser.add_argument("--label-dir", type=str, default=None,
                        help="24p txt labels directory (24p family)")
    parser.add_argument("--per-class-ap", action="store_true",
                        help="print the per-class AP table (bbox family)")
    parser.add_argument("--testdev", action="store_true",
                        help="score test_ann (test2017/) through "
                             "./yolox_testdev_2017.json")
    parser.add_argument("--legacy", action="store_true",
                        help="RGB in 0..1, ImageNet-normalised input")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return parser


def eval_weights(path: str):
    """The state_dict to evaluate from ``path``: a port checkpoint's model
    with its EMA parameters and statistics laid over it, or the file's own
    state_dict."""
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = payload.get("state") if isinstance(payload, dict) else None
    if not isinstance(state, dict) or "model" not in state:
        return payload
    return {**state["model"], **(state.get("ema_params") or {}),
            **(state.get("ema_batch_stats") or {})}


def main(argv=None):
    args = make_parser().parse_args(argv)
    from ..exp import Exp, get_exp

    exp = get_exp(args.exp_file, args.name)
    bbox = isinstance(exp, Exp)
    if args.opts:
        exp.merge(args.opts)
    if args.data_dir:
        exp.data_dir = args.data_dir
    if args.label_dir:
        if bbox:
            raise SystemExit("--label-dir reads 24p labels; a bbox exp "
                             "reads data_dir/annotations")
        exp.label_dir = args.label_dir
    if args.conf is not None:
        exp.test_conf = args.conf
    if args.nms is not None:
        exp.nmsthre = args.nms
    if args.tsize is not None:
        exp.test_size = (args.tsize, args.tsize)
    if bbox and not exp.data_dir:
        raise SystemExit("set --data-dir (or data_dir) to a COCO-format "
                         "directory, or for VOC the folder of VOCdevkit/")
    if not bbox and not (exp.data_dir and exp.label_dir):
        raise SystemExit("set --data-dir and --label-dir (or data_dir and "
                         "label_dir) to the images and the 24p txt labels")

    model = exp.get_model(args.device)
    if args.ckpt:
        model.load_state_dict(eval_weights(args.ckpt), strict=True)
    # the 24p family's get_evaluator takes neither testdev nor legacy (COCO
    # bbox notions): pass only what the exp's signature accepts
    accepted = inspect.signature(exp.get_evaluator).parameters
    extra = {k: v for k, v in (("testdev", args.testdev),
                               ("legacy", args.legacy),
                               ("per_class_AP", args.per_class_ap))
             if k in accepted}
    evaluator = exp.get_evaluator(batch_size=args.batch_size, **extra)
    # the diagnostic command line splits forward and NMS time
    ap50_95, ap50, summary = (exp.eval(model, evaluator, time_split=True)
                              if bbox else exp.eval(model, evaluator))
    print(summary)
    print(f"AP50:95 = {ap50_95:.4f}  AP50 = {ap50:.4f}", flush=True)
    return ap50_95, ap50


if __name__ == "__main__":
    main()
