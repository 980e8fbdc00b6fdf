"""The bbox evaluation's options in the port against ``eop_tpu``:
``ValTransform(legacy=True)`` (within 1e-6), ``testdev`` (``test_ann``
read, the same ``./yolox_testdev_2017.json`` written), the forward / NMS
split of the summary (eop_tpu's three times, forward + NMS = inference,
the NMS estimate clamped to the loop's total), and ``tools.eval
--testdev --legacy``: taken by a bbox exp, dropped by the 24p exp, whose
``get_evaluator`` takes neither here or in eop_tpu."""

import inspect
import json
import os
import re
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eop_tpu.data.augment import ValTransform as JValTransform  # noqa: E402
from eop_tpu.eval import Detections as JDetections  # noqa: E402
from eop_tpu.eval.coco_evaluator import COCOEvaluator as JEvaluator  # noqa: E402
from eop_tpu.exp import Exp24P as JExp24P  # noqa: E402
from eop_tpu_torch.data import augment  # noqa: E402
from eop_tpu_torch.data.augment import ValTransform  # noqa: E402
from eop_tpu_torch.eval import coco_evaluator  # noqa: E402
from eop_tpu_torch.eval.postprocess import Detections  # noqa: E402
from eop_tpu_torch.exp import Exp, Exp24P  # noqa: E402
from eop_tpu_torch.tools import eval as eval_cli  # noqa: E402
from eop_tpu_torch.utils.synth import (  # noqa: E402
    write_24p_dataset,
    write_coco_dataset,
)

ROOT = Path(__file__).resolve().parents[1]
SIZE = (64, 64)
TINY = ["depth", "0.33", "width", "0.25", "num_classes", "3",
        "input_size", "(64,64)", "test_size", "(64,64)",
        "data_num_workers", "0"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (tests/test_torch_bbox_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """A seeded COCO directory whose val split is also its test split
    (``test2017/``, ``instances_test2017.json``), as test-dev is laid
    out."""
    root = str(tmp_path_factory.mktemp("coco"))
    write_coco_dataset(root, 2, 4, (96, 128), num_classes=3, seed=4)
    shutil.copytree(os.path.join(root, "val2017"),
                    os.path.join(root, "test2017"))
    shutil.copy(os.path.join(root, "annotations", "instances_val2017.json"),
                os.path.join(root, "annotations", "instances_test2017.json"))
    return root


@pytest.mark.parametrize("hw", [(64, 64), (96, 128), (50, 40)])
def test_legacy_val_transform_matches_eop_tpu(hw, monkeypatch):
    """RGB, 0..1, ImageNet-normalised, float32: within 1e-6 of eop_tpu's
    (cv2's resize swapped in where the letterbox resizes; at the input size
    nothing resizes)."""
    monkeypatch.setattr(augment, "resize_host", lambda img, size: cv2.resize(
        img, (size[1], size[0]), interpolation=cv2.INTER_LINEAR))
    img = np.random.RandomState(hw[0]).randint(0, 256, (*hw, 3)).astype(
        np.uint8)
    got, rows = ValTransform(legacy=True)(img, None, SIZE)
    want, jrows = JValTransform(legacy=True)(img, None, SIZE)
    assert got.dtype == want.dtype == np.float32 and got.shape == (*SIZE, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rows, jrows)
    plain, _ = ValTransform()(img, None, SIZE)
    np.testing.assert_allclose(
        got, (plain[..., ::-1] / 255 - (0.485, 0.456, 0.406))
        / (0.229, 0.224, 0.225), atol=1e-6)


def detections(dataset, n: int):
    """Noisy label rows of the first ``n`` images with false positives."""
    rng = np.random.RandomState(3)
    rows = np.zeros((n, 300, 7), np.float32)
    valid = np.zeros((n, 300), bool)
    for b in range(n):
        rec = dataset.load_anno(b)
        k = len(rec)
        rows[b, :k, :4] = rec[:, :4] + rng.randn(k, 4) * 2
        rows[b, :k, 4:6] = rng.uniform(0.3, 1, (k, 2))
        rows[b, :k, 6] = rec[:, 4]
        rows[b, k:k + 2, :4] = [[5, 5, 30, 30]] * 2
        rows[b, k:k + 2, 4:7] = [0.5, 0.5, 1]
        valid[b, :k + 2] = True
    return rows, valid


def test_testdev_reads_test_ann_and_writes_eop_tpus_json(coco_dir, tmp_path,
                                                         monkeypatch):
    """``get_evaluator(testdev=True)`` reads ``test_ann`` from
    ``test2017/``; scoring writes ``./yolox_testdev_2017.json`` byte-equal
    to eop_tpu's, and the same AP."""
    exp = Exp()
    exp.data_dir, exp.test_size, exp.num_classes = coco_dir, SIZE, 3
    exp.data_num_workers = 0
    ev = exp.get_evaluator(4, testdev=True)
    ds = ev.dataloader.dataset
    assert (ds.name, ds.json_file, ev.testdev) == (
        "test2017", "instances_test2017.json", True)
    rows, valid = detections(ds, 4)
    info = [torch.full((4,), 96), torch.full((4,), 128)]
    ids = torch.tensor([[i] for i in ds.ids])
    dets = ev.convert_to_coco_format(rows, valid, info, ids)
    ref = JEvaluator(ev.dataloader, SIZE, 0.01, 0.65, 3, testdev=True)
    assert dets == ref.convert_to_coco_format(JDetections(rows, valid), info,
                                              ids)
    aps = []
    for name, fn in (("port", ev.evaluate_prediction),
                     ("ref", lambda d: ref.evaluate_prediction(
                         d, (0.0, 0.0, 1)))):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        aps.append(fn(dets)[:2])
    assert aps[0] == aps[1] and 0.1 < aps[0][0] < aps[0][1] <= 1
    written = [(tmp_path / n / "yolox_testdev_2017.json").read_bytes()
               for n in ("port", "ref")]
    assert written[0] == written[1] and json.loads(written[0]) == json.loads(
        json.dumps(dets))


def test_summary_line_splits_forward_and_nms(coco_dir):
    """The summary's first line is eop_tpu's for the same statistics (per
    image), and from a run with a decode function forward + NMS =
    inference, the NMS share taken from the estimate."""
    exp = Exp()
    exp.data_dir, exp.test_size, exp.num_classes = coco_dir, SIZE, 3
    exp.data_num_workers = 0
    ev = exp.get_evaluator(2)
    ref = JEvaluator(ev.dataloader, SIZE, 0.01, 0.65, 3)
    stats = (0.5, 0.125, 2)
    got = ev.evaluate_prediction([], stats)[2].splitlines()[0]
    want = ref.evaluate_prediction([], stats)[2].splitlines()[0]
    assert got == want == ("Average forward time: 93.75 ms, Average NMS time "
                           "(estimated): 31.25 ms, Average inference time: "
                           "125.00 ms")

    model = exp.get_model("cpu")
    _, _, summary = exp.eval(model, ev, time_split=True)
    times = [float(v) for v in re.findall(r"([0-9.]+) ms", summary.split(
        "\n")[0])]
    assert len(times) == 3 and times[0] > 0
    assert abs(times[0] + times[1] - times[2]) <= 0.011
    assert 0 <= ev.timings["nms_s"] <= ev.timings["inference_s"]
    assert ev.timings["batches"] == 2 and ev.timings["images"] == 4


def test_nms_estimate_is_clamped():
    """NMS = best infer - best decode, never below 0 (decode slower) and,
    per batch times the batches, never above the loop's total."""
    rows = torch.zeros(1, 300, 7)
    calls = []

    def infer(_):
        # the loop's three calls are quick, the estimate's slow
        calls.append(None)
        time.sleep(0.001 if len(calls) <= 3 else 0.02)
        return Detections(rows, torch.zeros(1, 300, dtype=torch.bool))

    def slow_decode(_):
        time.sleep(0.03)
        return rows

    assert coco_evaluator.estimate_nms_time(infer, slow_decode, None) == 0.0
    calls.clear()
    batches = [(torch.zeros(1, 8, 8, 3), None, None, None)] * 2
    parts, timings = coco_evaluator.run_batches(
        batches, infer, lambda *a: a[0].shape, decode_fn=lambda _: rows)
    assert parts == [(1, 300, 7)] * 2 and len(calls) == 3 + 4
    assert timings["batches"] == 2 and timings["inference_s"] < 0.02
    assert timings["nms_s"] == timings["inference_s"]


def record_evaluator_kwargs(monkeypatch, cls):
    seen = []
    original = cls.get_evaluator

    def wrapped(self, batch_size, **kw):
        seen.append(kw)
        return original(self, batch_size, **kw)

    wrapped.__signature__ = inspect.signature(original)
    monkeypatch.setattr(cls, "get_evaluator", wrapped)
    return seen


def test_eval_cli_testdev_legacy_on_bbox_and_24p(coco_dir, tmp_path,
                                                  monkeypatch, capsys):
    """``tools.eval --testdev --legacy``: a bbox exp gets both (test2017
    scored, the json written in the working directory); the 24p exp's
    get_evaluator takes neither, in the port as in eop_tpu, and they are
    dropped: it evaluates as without them."""
    monkeypatch.chdir(tmp_path)
    seen = record_evaluator_kwargs(monkeypatch, Exp)
    ap50_95, ap50 = eval_cli.main(
        ["-n", "yolox-s", "-b", "2", "--data-dir", coco_dir, "--device",
         "cpu", "--testdev", "--legacy"] + TINY + ["test_conf", "1e-6"])
    assert seen == [{"testdev": True, "legacy": True, "per_class_AP": False}]
    assert (tmp_path / "yolox_testdev_2017.json").exists()
    out = capsys.readouterr().out
    assert "Average NMS time (estimated)" in out and 0 <= ap50_95 <= ap50

    for cls in (Exp24P, JExp24P):
        params = inspect.signature(cls.get_evaluator).parameters
        assert "testdev" not in params and "legacy" not in params
    img_dir, lab_dir = write_24p_dataset(str(tmp_path / "d24p"), 2, (48, 64),
                                         seed=1)
    seen24 = record_evaluator_kwargs(monkeypatch, Exp24P)
    eval_cli.main(["-f", str(ROOT / "load_eval" / "yolox_24p_eval.py"),
                   "-b", "2",
                   "--data-dir", img_dir, "--label-dir", lab_dir,
                   "--device", "cpu", "--testdev", "--legacy"] + TINY)
    assert seen24 == [{}]
    assert re.search(r"AP50:95 = [0-9.]+  AP50 = [0-9.]+",
                     capsys.readouterr().out)
