"""The bbox family's command lines on the CPU: ``tools.train`` across the
no-aug switch and on with ``--resume``, then ``tools.eval`` on its
checkpoint, over a seeded COCO-format directory (tiny model, 64 px)."""

import os
import re

import pytest
import torch

from eop_tpu_torch.exp import get_exp
from eop_tpu_torch.tools import eval as eval_cli
from eop_tpu_torch.tools import train as train_cli
from eop_tpu_torch.tools.eval import eval_weights
from eop_tpu_torch.utils.synth import write_coco_dataset

TINY = ["depth", "0.33", "width", "0.25", "num_classes", "3",
        "input_size", "(64,64)", "test_size", "(64,64)"]

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (the CLI test took 465 s in a 6-worker run, 8 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    return write_coco_dataset(root, 4, 2, (96, 128), num_classes=3, seed=2)


def _losses(log_text):
    """(l1 loss, epoch) of every log line."""
    return [(float(m.group(2)), int(m.group(1))) for m in re.finditer(
        r"epoch: (\d+)/\d+, .*?l1_loss: ([0-9.]+)", log_text)]


def test_train_across_the_switch_resume_and_eval(coco_dir, tmp_path, capsys):
    """Two epochs with no_aug_epochs 0: the switch comes at the start of the
    second (the reference's placement), saving last_mosaic_epoch; the L1
    term is 0 before it and positive after; each epoch evaluates.  Then
    --resume runs the third epoch from latest_ckpt.pth, and tools.eval
    scores its checkpoint and prints the AP line."""
    out = str(tmp_path)
    common = ["-n", "yolox-s", "-b", "2", "--data-dir", coco_dir, "--device",
              "cpu"]
    opts = TINY + ["no_aug_epochs", "0", "eval_interval", "1",
                   "data_num_workers", "0", "print_interval", "1",
                   "multiscale_range", "0", "output_dir", out]
    train_cli.main(common + opts + ["max_epoch", "2"])
    run_dir = os.path.join(out, "yolox_s")
    assert {"last_mosaic_epoch_ckpt.pth", "latest_ckpt.pth",
            "last_epoch_ckpt.pth"} <= set(os.listdir(run_dir))
    with open(os.path.join(run_dir, "train_log.txt")) as f:
        log = f.read()
    losses = _losses(log)
    assert len(losses) == 4 and log.count("AP50:95=") == 2
    assert all(l1 == 0 for l1, ep in losses if ep == 1)
    assert all(l1 > 0 for l1, ep in losses if ep == 2)
    assert log.count("No mosaic aug now") == 1

    train_cli.main(common + ["--resume"] + opts + ["max_epoch", "3"])
    with open(os.path.join(run_dir, "train_log.txt")) as f:
        resumed = f.read()[len(log):]
    assert "start train epoch3" in resumed and "epoch1" not in resumed
    assert all(l1 > 0 for l1, _ in _losses(resumed))

    capsys.readouterr()
    ap50_95, ap50 = eval_cli.main(
        ["-n", "yolox-s", "-c", os.path.join(run_dir, "latest_ckpt.pth"),
         "-b", "2", "--data-dir", coco_dir, "--device", "cpu",
         "--per-class-ap"] + TINY + ["data_num_workers", "0",
                                     "test_conf", "1e-6"])
    printed = capsys.readouterr().out
    assert re.search(r"AP50:95 = [0-9.]+  AP50 = [0-9.]+", printed)
    assert "| class" in printed and 0.0 <= ap50_95 <= ap50 <= 1.0


@pytest.mark.parametrize("flag", [["--tensor", "2"], ["--fsdp"],
                                  ["--spatial", "2"], ["--multi-host"]])
def test_unported_train_options_raise(coco_dir, tmp_path, flag):
    """``--tensor 2`` and ``--spatial 2`` in one process raise
    ``make_mesh``'s "do not split" ``ValueError`` (one rank does not split
    into two, as one device does not in ``eop_tpu``); ``--multi-host``
    without ``--coordinator`` or torchrun's environment raises naming
    them; ``--fsdp`` in one process trains (it shards nothing without a
    group) and its checkpoint loads strictly."""
    argv = (["-n", "yolox-s", "-b", "2", "--data-dir", coco_dir, "--device",
             "cpu"] + flag + TINY + ["output_dir", str(tmp_path)])
    if flag[0] in ("--tensor", "--spatial"):
        with pytest.raises(ValueError, match="1 devices do not split"):
            train_cli.main(argv)
    elif flag[0] == "--multi-host":
        with pytest.raises(ValueError, match="--coordinator.*torchrun"):
            train_cli.main(argv)
    else:
        train_cli.main(argv + ["max_epoch", "1", "no_aug_epochs", "0",
                               "data_num_workers", "0", "multiscale_range",
                               "0"])
        exp = get_exp(exp_name="yolox-s")
        exp.merge(TINY)
        exp.get_model("cpu").load_state_dict(eval_weights(os.path.join(
            str(tmp_path), "yolox_s", "latest_ckpt.pth")), strict=True)
