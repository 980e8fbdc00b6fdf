"""Distributed evaluation on the CPU: two ranks over gloo
(``tests/_torch_dist_child.py``), each with the strided rows
``range(rank, N, world)`` of the set, the detections gathered and scored
on every rank, against one process: COCO (``COCOEvaluator``) and PASCAL
VOC (``VOCEvaluator``, the VOC exp file), a seeded model's AP (0 at this
size; the COCO detection count), a label oracle's AP of 1, and a jittered
oracle's AP between 0 and 1, which every image's detections decide;
``get_sharded_infer_fn`` against ``get_infer_fn``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from eop_tpu_torch.exp import get_exp
from eop_tpu_torch.utils.synth import (
    LabelOracle,
    write_coco_dataset,
    write_voc_devkit,
)

from _torch_dist_child import jittered, run_ranks

ROOT = Path(__file__).resolve().parents[1]
VOC_EXP = ROOT / "exps" / "example" / "yolox_voc" / "yolox_voc_s.py"
TINY = ["depth", "0.33", "width", "0.125", "input_size", "(64,64)",
        "test_size", "(64,64)", "data_num_workers", "0", "test_conf",
        "0.001"]
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setups(tmp):
    coco = write_coco_dataset(str(tmp / "coco"), 1, 7, (64, 96),
                              num_classes=3, seed=2)
    write_voc_devkit(str(tmp / "voc"), n_trainval=1, n_test=7, hw=(64, 96),
                     seed=3)
    return {
        "coco": {"exp_name": "yolox-s",
                 "opts": TINY + ["num_classes", "3", "data_dir", coco]},
        "voc": {"exp_file": str(VOC_EXP),
                "opts": TINY + ["data_dir", str(tmp / "voc")]},
    }


@pytest.fixture(scope="module", params=["coco", "voc"])
def evaluated(request, tmp_path_factory):
    """Two ranks, then one process, on the same seeded weights."""
    tmp = tmp_path_factory.mktemp(f"dist_eval_{request.param}")
    inp = setups(tmp)[request.param]
    exp = get_exp(inp.get("exp_file"), inp.get("exp_name"))
    exp.merge(inp["opts"])
    model = exp.get_model("cpu", seed=1)
    imgs = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(
        5)) * 255
    ranks = run_ranks("eval", {**inp, "weights": model.state_dict(),
                               "batch": BATCH, "imgs": imgs}, str(tmp))
    ev = exp.get_evaluator(BATCH)
    ap = exp.eval(model, ev)[:2]
    oracles = {}
    for name, wrap in (("oracle", lambda d: d), ("jittered", jittered)):
        oracle_ev = exp.get_evaluator(BATCH)
        oracle = LabelOracle(oracle_ev.dataloader.dataset, "cpu")
        oracles[name] = oracle_ev.evaluate(
            lambda imgs, o=oracle, w=wrap: w(o(imgs)))[:2]
    infer = exp.get_infer_fn(model, "cpu")(imgs)
    return dict(ranks=ranks, ap=ap, infer=infer, **oracles,
                detections=ev.timings.get("detections"),
                n=len(ev.dataloader.dataset))


def test_ranks_load_strided_rows(evaluated):
    rows = [r["rows"] for r in evaluated["ranks"]]
    assert rows == [list(range(0, evaluated["n"], 2)),
                    list(range(1, evaluated["n"], 2))]


def test_distributed_ap_is_the_one_process_ap(evaluated):
    for r in evaluated["ranks"]:
        np.testing.assert_allclose(r["ap"], evaluated["ap"], rtol=0,
                                   atol=1e-6)
        assert r["detections"] == evaluated["detections"]
    assert evaluated["ranks"][0]["ap"] == evaluated["ranks"][1]["ap"]


def test_distributed_label_oracle_scores_one(evaluated):
    assert evaluated["oracle"] == (1.0, 1.0)
    for r in evaluated["ranks"]:
        assert r["oracle"] == (1.0, 1.0)


def test_distributed_jittered_oracle_ap_is_the_one_process_ap(evaluated):
    ap5095, ap50 = evaluated["jittered"]
    assert 0.05 < ap5095 < 0.95 and ap5095 < ap50
    for r in evaluated["ranks"]:
        np.testing.assert_allclose(r["jittered"], evaluated["jittered"],
                                   rtol=0, atol=1e-12)


def test_sharded_infer_fn_is_the_infer_fn(evaluated):
    """Each rank ran two of the four images; every rank gets all four."""
    want = evaluated["infer"]
    for r in evaluated["ranks"]:
        got = r["sharded"]
        assert torch.equal(got.valid, want.valid)
        torch.testing.assert_close(got.rows, want.rows, atol=1e-4, rtol=1e-5)
