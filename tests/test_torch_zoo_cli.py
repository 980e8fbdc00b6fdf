"""``tools.train`` and ``tools.eval`` with ``-n yolox-nano`` and ``-n
yolox-tiny`` on the CPU over a seeded COCO-format directory: one epoch of
two steps at 64 px (the exps' own depth and width, 3 classes), then the AP
line of its checkpoint.  ``-n yolov3`` (Darknet-53 at full width, 7 s a
run here) runs the same commands on the card in ``chip_smoke.py``'s
``train_zoo`` and ``eval_zoo``; its model and step are held against
``eop_tpu`` in ``tests/test_torch_zoo_models.py`` and
``tests/test_torch_zoo_step.py``."""

import os
import re

import pytest
import torch

from eop_tpu_torch.tools import eval as eval_cli
from eop_tpu_torch.tools import train as train_cli
from eop_tpu_torch.utils.synth import write_coco_dataset

SMALL = ["num_classes", "3", "input_size", "(64,64)", "test_size", "(64,64)"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    return write_coco_dataset(root, 4, 2, (96, 128), num_classes=3, seed=3)


@pytest.mark.parametrize("name", ["yolox-nano", "yolox-tiny"])
def test_train_then_eval_by_name(name, coco_dir, tmp_path, capsys):
    out = str(tmp_path)
    common = ["-n", name, "--data-dir", coco_dir, "--device", "cpu"]
    train_cli.main(common + ["-b", "2"] + SMALL + [
        "max_epoch", "1", "no_aug_epochs", "0", "eval_interval", "1",
        "data_num_workers", "0", "print_interval", "1", "multiscale_range",
        "0", "random_size", "(2,2)", "output_dir", out])
    run_dir = os.path.join(out, name.replace("-", "_"))
    with open(os.path.join(run_dir, "train_log.txt")) as f:
        log = f.read()
    losses = [float(v) for v in re.findall(r"total_loss: ([0-9.]+)", log)]
    assert len(losses) == 2 and log.count("AP50:95=") == 1
    capsys.readouterr()
    ap50_95, ap50 = eval_cli.main(
        common + ["-c", os.path.join(run_dir, "latest_ckpt.pth"), "-b", "2"]
        + SMALL + ["data_num_workers", "0", "test_conf", "1e-6"])
    assert re.search(r"AP50:95 = [0-9.]+  AP50 = [0-9.]+",
                     capsys.readouterr().out)
    assert 0.0 <= ap50_95 <= ap50 <= 1.0
