"""Train the 24-point detector from image and label files (counterpart of
``tools/train_24p.py``).

    python -m eop_tpu_torch.tools.train_24p -f load_train/yolox_24p_train.py \
        -b 32 --data-dir IMGS --label-dir LABELS [--eval] [--device cuda] \
        [key value ...]

``-f`` reads an exp file of ``load_train/`` or ``load_eval/`` without
importing it (``exp/build.py``).  Trailing ``key value`` pairs override exp
attributes and come after every flag.  Runs on the card; ``--device cpu``
runs on the CPU.  Checkpoints and the log go to ``output_dir/exp_name``.
Several processes, one per GPU, under torchrun or with ``--multi-host
--coordinator HOST:PORT --num-processes N --process-id I`` (``-b`` is the
global batch; ``--fsdp`` shards the state), as ``tools/train.py`` says.
``--spatial S`` / ``--tensor T`` shard each image's rows / the qualifying
convs' output channels over S / T ranks of each data row (the world splits
into data x S x T); ``--profile-port PORT`` has rank 0 answer live
profiling requests on PORT (``tools.profile_train --attach HOST:PORT``);
``--no-prewarm`` is accepted and does nothing.
"""

from __future__ import annotations

import argparse

from .train import add_parallel_args, launched


def make_parser():
    parser = argparse.ArgumentParser("eop_tpu_torch.tools.train_24p")
    parser.add_argument("-f", "--exp_file", type=str,
                        default="load_train/yolox_24p_train.py")
    parser.add_argument("-b", "--batch_size", type=int, default=20)
    parser.add_argument("-l", "--lr", type=float, default=0.01)
    parser.add_argument("--resume", action="store_true",
                        help="continue from output_dir/exp_name/"
                             "last_epoch_ckpt.pth (or -c) at its epoch")
    parser.add_argument("-c", "--ckpt", type=str, default=None,
                        help="the port's checkpoint to start from")
    parser.add_argument("-e", "--start_epoch", type=int, default=None)
    parser.add_argument("--data-dir", type=str, default=None,
                        help="images directory")
    parser.add_argument("--label-dir", type=str, default=None,
                        help="24p txt labels directory")
    parser.add_argument("--max-epoch", type=int, default=None)
    parser.add_argument("--eval", action="store_true",
                        help="evaluate COCO-24p AP every eval_interval "
                             "epochs and keep best_ckpt.pth")
    parser.add_argument("--accum", type=int, default=1,
                        help="gradient accumulation micro-steps per "
                             "optimizer step")
    add_parallel_args(parser)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="exp overrides: key value ...")
    return parser


def build_exp(args):
    """The exp of ``-f``, with the overrides, data directories and epoch
    count of the command line."""
    from ..exp import get_exp

    exp = get_exp(args.exp_file)
    if args.opts:
        exp.merge(args.opts)
    if args.data_dir:
        exp.data_dir = args.data_dir
    if args.label_dir:
        exp.label_dir = args.label_dir
    if args.max_epoch:
        exp.max_epoch = args.max_epoch
    if not (exp.data_dir and exp.label_dir):
        raise SystemExit("set --data-dir and --label-dir (or data_dir and "
                         "label_dir) to the images and the 24p txt labels")
    return exp


def main(argv=None):
    args = make_parser().parse_args(argv)
    from ..train.trainer_24p import Trainer24P

    with launched(args):
        Trainer24P(build_exp(args), args).train()


if __name__ == "__main__":
    from ..utils.logger import catch

    catch(main)()
