"""COCO-24p AP of a checkpoint over image and label files (counterpart of
the 24p family of ``tools/eval.py``).

    python -m eop_tpu_torch.tools.eval -f load_eval/yolox_24p_eval.py \
        -c CKPT -b 8 --data-dir IMGS --label-dir LABELS [--device cuda] \
        [key value ...]

``-c`` takes the port's own checkpoint (``train/checkpoint.py``; its EMA
weights where it has them, as the trainer evaluates) or a state_dict in the
reference's key names; either loads strictly.  Without ``-c`` the model has
seeded random weights.  Prints the COCO summary, then
``AP50:95 = x  AP50 = y``.  Runs on the card; ``--device cpu`` runs on the
CPU.
"""

from __future__ import annotations

import argparse


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
    parser.add_argument("--label-dir", type=str, default=None)
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
    from ..exp import get_exp

    exp = get_exp(args.exp_file, args.name)
    if args.opts:
        exp.merge(args.opts)
    if args.data_dir:
        exp.data_dir = args.data_dir
    if args.label_dir:
        exp.label_dir = args.label_dir
    if args.conf is not None:
        exp.test_conf = args.conf
    if args.nms is not None:
        exp.nmsthre = args.nms
    if args.tsize is not None:
        exp.test_size = (args.tsize, args.tsize)
    if not (exp.data_dir and exp.label_dir):
        raise SystemExit("set --data-dir and --label-dir (or data_dir and "
                         "label_dir) to the images and the 24p txt labels")

    model = exp.get_model(args.device)
    if args.ckpt:
        model.load_state_dict(eval_weights(args.ckpt), strict=True)
    evaluator = exp.get_evaluator(batch_size=args.batch_size)
    ap50_95, ap50, summary = exp.eval(model, evaluator)
    print(summary)
    print(f"AP50:95 = {ap50_95:.4f}  AP50 = {ap50:.4f}", flush=True)
    return ap50_95, ap50


if __name__ == "__main__":
    main()
