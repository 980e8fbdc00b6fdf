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
evaluation prints ``AP50:95=x AP50=y``.

Several processes, one per GPU (``-b`` is the global batch):

    torchrun --nproc-per-node 8 -m eop_tpu_torch.tools.train -n yolox-l \
        -b 64 --data-dir DIR [--fsdp]
    python -m eop_tpu_torch.tools.train ... --multi-host \
        --coordinator HOST:PORT --num-processes N --process-id I

(``--platform cpu|gpu`` picks the device as ``--device`` does.)
``--spatial S`` shards each image's rows over S ranks and ``--tensor T``
the qualifying convs' output channels over T ranks, as ``eop_tpu``'s mesh
does (the world splits into data x S x T; ``-b`` splits over the data
ranks); a world that does not split raises ``ValueError``.
``--profile-port`` is accepted and raises ``NotImplementedError``
(ROADMAP.md queue 1 item 8); ``--no-prewarm`` is accepted and does
nothing.
"""

from __future__ import annotations

import argparse
import contextlib


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
    parser.add_argument("--accum", type=int, default=1,
                        help="micro-batches a step (the batch must split)")
    add_parallel_args(parser)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="exp overrides: key value ...")
    return parser


def add_parallel_args(parser) -> None:
    """``eop_tpu``'s parallel, platform and profiling options of both train
    command lines: ``--fsdp``, ``--spatial``, ``--tensor``,
    ``--multi-host`` with ``--coordinator``, ``--num-processes`` and
    ``--process-id``, and ``--platform`` work (:func:`launched`,
    ``train/trainer.py::Parallel``); ``--profile-port`` raises
    ``NotImplementedError`` when set
    (``train/trainer.py::reject_unported``); ``--no-prewarm`` does
    nothing."""
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="cuda (default; cuda:LOCAL_RANK under several "
                             "processes) or cpu")
    parser.add_argument("--no-prewarm", dest="prewarm", action="store_false",
                        help="accepted and ignored: PyTorch compiles nothing "
                             "per shape, so the port has no prewarm "
                             "(ROADMAP.md queue 1, not ported on purpose)")
    parser.add_argument("--spatial", type=int, default=1,
                        help="shard each image's rows over this many ranks "
                             "(halo rows exchanged around every conv of the "
                             "stem through dark4, gathered before dark5); "
                             "the world must split into data x spatial x "
                             "tensor")
    parser.add_argument("--tensor", type=int, default=1,
                        help="shard the output channels of the convs whose "
                             "kernel divides over this many ranks (with at "
                             "least 256 elements, as eop_tpu's param_specs); "
                             "the world must split into data x spatial x "
                             "tensor")
    parser.add_argument("--profile-port", type=int, default=None,
                        help="not ported: raises (ROADMAP.md queue 1 item 8)")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard the parameters, the momentum and the EMA "
                             "over the ranks (fully_shard): gathered for "
                             "each forward and backward, gradients "
                             "reduce-scattered")
    parser.add_argument("--multi-host", action="store_true",
                        help="one of several processes: start the process "
                             "group from --coordinator/--num-processes/"
                             "--process-id, or from torchrun's environment "
                             "(under torchrun it starts without this flag)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="HOST:PORT of rank 0 (with --multi-host)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="the world size (with --multi-host)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank (with --multi-host)")
    parser.add_argument("--platform", type=str, default=None,
                        help="cpu or gpu: the device, as eop_tpu's pins the "
                             "platform (--device cpu / cuda)")


PLATFORMS = {"cpu": "cpu", "gpu": "cuda"}


@contextlib.contextmanager
def launched(args):
    """The process set up as the command line asks, for the length of the
    ``with``: ``--platform`` sets ``args.device`` (any value other than
    ``cpu`` or ``gpu`` raises ``ValueError``); with ``--multi-host``, or
    under torchrun, the default process group starts
    (``parallel.dist.init_distributed``: NCCL on the card, gloo on the CPU)
    and is destroyed at the end.  ``--coordinator``, ``--num-processes``
    and ``--process-id`` without ``--multi-host`` raise ``SystemExit``.
    The options that are not ported raise first, before any data is
    read; so do ``--spatial`` / ``--tensor`` that do not split the world
    (in the trainer's ``Parallel.of``)."""
    import torch.distributed as dist

    from ..parallel.dist import init_distributed, under_torchrun
    from ..train.trainer import reject_unported
    from ..utils.device import resolve_device

    reject_unported(args)
    if args.platform is not None:
        if args.platform not in PLATFORMS:
            raise ValueError(f"--platform {args.platform!r}: the port runs on "
                             f"{' or '.join(PLATFORMS)}")
        device = PLATFORMS[args.platform]
        if args.device not in (None, device):
            raise SystemExit(f"--platform {args.platform} and --device "
                             f"{args.device} disagree")
        args.device = device
    mh = ("coordinator", "num_processes", "process_id")
    given = [f"--{n.replace('_', '-')}" for n in mh
             if getattr(args, n) is not None]
    if given and not args.multi_host:
        raise SystemExit(f"{', '.join(given)} needs --multi-host")
    made = False
    if args.multi_host or under_torchrun():
        made = init_distributed(resolve_device(args.device),
                                args.coordinator, args.num_processes,
                                args.process_id)
    try:
        yield args
    finally:
        if made:
            dist.destroy_process_group()


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

    with launched(args):
        Trainer(build_exp(args), args).train()


if __name__ == "__main__":
    main()
