"""The port's 24p training command line over two processes on the CPU
(gloo), as tests/test_multihost_cli.py drives ``tools/train_24p.py``:

* ``--multi-host --coordinator --num-processes --process-id``, with and
  without ``--fsdp --accum 2``, and a torchrun launch without the flags;
* both ranks exit cleanly and log the same finite global-batch loss;
* the log file and the checkpoints are rank 0's alone, and the checkpoint
  loads strictly into a one-device model;
* the ranks' loaders draw disjoint halves of the dataset;
* ``train_24p --spatial 2`` and ``train --tensor 2`` over two processes
  (``--multi-host``): both ranks log the same losses and the checkpoint
  loads strictly into a one-device model.
"""

import itertools
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from eop_tpu_torch.exp import get_exp
from eop_tpu_torch.tools.eval import eval_weights
from eop_tpu_torch.utils.synth import write_24p_dataset, write_coco_dataset

from _torch_dist_child import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["depth", "0.33", "width", "0.125", "num_classes", "3",
        "input_size", "(64,64)", "test_size", "(64,64)",
        "data_num_workers", "0", "print_interval", "1"]
TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_24p_dataset(str(tmp_path_factory.mktemp("mp24p")), 8,
                             (64, 64), seed=4)


def _run(cmds, env):
    """Run the commands at once; every one must exit 0 within the limit."""
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
    return outs


def _losses(text):
    return [float(m) for m in re.findall(r"iter \d+/\d+ loss ([-\d.naif]+)",
                                         text)]


def _strict_load(ckpt):
    exp = get_exp("load_train/yolox_24p_train.py")
    exp.merge(TINY[:10])
    exp.get_model("cpu").load_state_dict(eval_weights(ckpt), strict=True)


@pytest.mark.parametrize("extra", [[], ["--fsdp", "--accum", "2"]],
                         ids=["replicated", "fsdp_accum"])
def test_train_24p_multi_host_flags(files, tmp_path, extra):
    img_dir, lab_dir = files
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    outdirs = [tmp_path / f"rank{i}" for i in range(2)]
    cmds = [[sys.executable, "-m", "eop_tpu_torch.tools.train_24p",
             "-b", "4", "--data-dir", img_dir, "--label-dir", lab_dir,
             "--max-epoch", "1", "--device", "cpu", "--multi-host",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(i), *extra, *TINY,
             "output_dir", str(outdirs[i])] for i in range(2)]
    outs = _run(cmds, env)
    # the same global-batch loss on both ranks, finite, each step
    per_rank = [_losses(o) for o in outs]
    assert len(per_rank[0]) == 2 and per_rank[0] == per_rank[1], per_rank
    assert all(math.isfinite(v) for v in per_rank[0])
    assert "world 2" in outs[0] and "place_state" in outs[1]
    # rank 0 alone writes
    rank0, rank1 = outdirs[0] / "yolox_24p", outdirs[1] / "yolox_24p"
    assert (rank0 / "train_log.txt").exists()
    ckpts = list(rank0.glob("*_ckpt.pth"))
    assert ckpts
    assert not rank1.exists() or not any(rank1.iterdir()), list(
        rank1.iterdir())
    _strict_load(str(ckpts[0]))
    if extra:
        assert "fsdp=True" in outs[0] and "shards nothing" not in outs[0]


def test_train_24p_under_torchrun(files, tmp_path):
    """torchrun's environment starts the group without the flags."""
    img_dir, lab_dir = files
    env = dict(os.environ, PYTHONPATH=REPO)
    (out,) = _run([[sys.executable, "-m", "torch.distributed.run",
                    "--nproc-per-node", "2", "--master-port",
                    str(free_port()), "-m", "eop_tpu_torch.tools.train_24p",
                    "-b", "4", "--data-dir", img_dir, "--label-dir", lab_dir,
                    "--max-epoch", "1", "--device", "cpu", *TINY,
                    "output_dir", str(tmp_path)]], env)
    assert out.count("world 2") == 2, out[-3000:]
    losses = sorted(_losses(out))   # both ranks' lines, interleaved
    assert len(losses) == 4 and losses[0::2] == losses[1::2], losses
    assert all(math.isfinite(v) for v in losses)
    _strict_load(str(next((tmp_path / "yolox_24p").glob("*_ckpt.pth"))))


def test_rank_loaders_draw_disjoint_halves(files):
    img_dir, lab_dir = files
    exp = get_exp("load_train/yolox_24p_train.py")
    exp.merge(TINY + ["data_dir", img_dir, "label_dir", lab_dir])
    drawn = []
    for rank in range(2):
        loader = exp.get_data_loader(4, is_distributed=True, rank=rank,
                                     world_size=2)
        assert loader.batch_sampler.batch_size == 2
        sampler = loader.batch_sampler.sampler
        drawn.append(set(itertools.islice(iter(sampler), 4)))
    assert drawn[0].isdisjoint(drawn[1])
    assert drawn[0] | drawn[1] == set(range(8))


@pytest.mark.parametrize("cli", ["train_24p --spatial 2", "train --tensor 2"])
def test_spatial_and_tensor_command_lines(files, tmp_path, cli):
    """Two ranks on one data row: one image's rows over the space pair, or
    the convs' channels over the model pair; one step of B=4 (24p) or an
    epoch of two steps of B=2 (bbox: mosaic switched off, its evaluation
    run)."""
    img_dir, lab_dir = files
    tool, flag, value = cli.split()
    if tool == "train":
        coco = write_coco_dataset(str(tmp_path / "coco"), 4, 2, (64, 64),
                                  num_classes=3, seed=2)
        args = ["-n", "yolox-s", "-b", "2", "--data-dir", coco]
        opts = TINY + ["max_epoch", "1", "no_aug_epochs", "0",
                       "multiscale_range", "0"]
    else:
        args = ["-b", "4", "--data-dir", img_dir, "--label-dir", lab_dir,
                "--max-epoch", "1"]
        opts = TINY
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    out = tmp_path / "out"
    cmds = [[sys.executable, "-m", f"eop_tpu_torch.tools.{tool}", *args,
             flag, value, "--device", "cpu", "--multi-host",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(i), *opts, "output_dir", str(out)]
            for i in range(2)]
    outs = _run(cmds, env)
    if tool == "train_24p":
        per_rank = [_losses(o) for o in outs]
        assert len(per_rank[0]) == 2 and per_rank[0] == per_rank[1]
        assert all(math.isfinite(v) for v in per_rank[0])
        ckpt = next((out / "yolox_24p").glob("*_ckpt.pth"))
        _strict_load(str(ckpt))
    else:
        losses = [re.findall(r"total_loss: ([-\d.naif]+)", o) for o in outs]
        assert losses[0] and losses[0] == losses[1], losses
        assert "tensor 2" in outs[0]
        exp = get_exp(exp_name="yolox-s")
        exp.merge(TINY[:6])
        exp.get_model("cpu").load_state_dict(eval_weights(
            str(out / "yolox_s" / "latest_ckpt.pth")), strict=True)
