"""Train a bbox-family detector (YOLOX-S/M/L/X, -Nano, -Tiny, YOLOv3) from
a COCO-format directory or a PASCAL VOC devkit (counterpart of
``tools/train.py``).

    python -m eop_tpu_torch.tools.train -n yolox-l -b 8 --data-dir DIR \
        [-f EXP_FILE] [--accum N] [--resume] [-c CKPT] [--device cuda] \
        [key value ...]
    python -m eop_tpu_torch.tools.train \
        -f exps/example/yolox_voc/yolox_voc_s.py -b 8 --data-dir ROOT

``DIR`` holds ``annotations/instances_{train,val}2017.json``,
``train2017/`` and ``val2017/``; for the VOC exp, ``ROOT`` holds
``VOCdevkit/VOC2007`` and ``VOC2012``.  ``--accum N`` runs N micro-batches
of ``-b / N`` images before each optimizer step.  ``-n`` names an exp of
``exps/default/``, ``-f`` reads an exp file whose ``Exp`` subclasses the
bbox ``Exp`` (``exp/build.py``); trailing ``key value`` pairs override exp attributes
and come after every flag.  Runs on the card; ``--device cpu`` runs on the
CPU.  Checkpoints and the log go to ``output_dir/<experiment name>``; each
evaluation prints ``AP50:95=x AP50=y``.  The options of ``tools/train.py``
that need a mesh or several hosts are accepted and raise.
"""

from __future__ import annotations

import argparse


def make_parser():
    parser = argparse.ArgumentParser("eop_tpu_torch.tools.train")
    parser.add_argument("-expn", "--experiment-name", type=str, default=None)
    parser.add_argument("-n", "--name", type=str, default=None,
                        help="model name, e.g. yolox-l")
    parser.add_argument("-f", "--exp_file", type=str, default=None)
    parser.add_argument("-b", "--batch_size", type=int, default=64)
    parser.add_argument("--resume", action="store_true",
                        help="continue from <output>/latest_ckpt.pth (or -c) "
                             "at its epoch")
    parser.add_argument("-c", "--ckpt", type=str, default=None,
                        help="the port's checkpoint to resume or fine-tune")
    parser.add_argument("-e", "--start_epoch", type=int, default=None)
    parser.add_argument("--cache", action="store_true",
                        help="cache resized images in a np.memmap file")
    parser.add_argument("--data-dir", type=str, default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--accum", type=int, default=1,
                        help="micro-batches a step (the batch must split)")
    # eop_tpu's parallel and profiling options: not ported, they raise
    parser.add_argument("--spatial", type=int, default=1)
    parser.add_argument("--tensor", type=int, default=1)
    parser.add_argument("--fsdp", action="store_true")
    parser.add_argument("--profile-port", type=int, default=None)
    parser.add_argument("--multi-host", action="store_true")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="exp overrides: key value ...")
    return parser


def build_exp(args):
    """The exp of ``-f`` or ``-n``, with the overrides and the data
    directory of the command line."""
    from ..exp import Exp, get_exp

    exp = get_exp(args.exp_file, args.name)
    if not isinstance(exp, Exp):
        raise SystemExit(f"{args.exp_file or args.name} is not a bbox exp; "
                         "train the 24p family with tools.train_24p")
    if args.opts:
        exp.merge(args.opts)
    if args.data_dir:
        exp.data_dir = args.data_dir
    if not exp.data_dir:
        raise SystemExit("set --data-dir (or data_dir) to a COCO-format "
                         "directory, or for VOC the folder of VOCdevkit/")
    return exp


def main(argv=None):
    args = make_parser().parse_args(argv)
    from ..train.trainer import Trainer

    Trainer(build_exp(args), args).train()


if __name__ == "__main__":
    main()
