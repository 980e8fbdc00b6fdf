"""The port's COCO-24p evaluator on the CPU against the JAX package's: the
label oracle, the AP of the same detections, the polygon boxes, and the
slice as a whole (JAX weights -> ``state_dict_from_jax`` -> ``Exp24P.eval``
over files).

Tolerances: polygon boxes exactly equal; AP of identical detections within
1e-12; the whole slice's detection rows within 1e-4 (absolute and relative,
fp32 through about a hundred layers, as tests/test_torch_serving.py holds
the serving path) where the valid masks agree, the masks equal, AP within
1e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eop_tpu.data.coco24p import COCO24PDataset as JDataset
from eop_tpu.data.coco24p import TrainTransform24P as JTransform
from eop_tpu.data.dataloading import DataLoader as JLoader
from eop_tpu.eval.evaluator_24p import Evaluator24P as JEvaluator
from eop_tpu.eval.evaluator_24p import polygon_rows_to_xyxy as j_xyxy
from eop_tpu.eval.postprocess import Detections as JDetections
from eop_tpu.exp.yolox_24p_base import Exp24P as JaxExp24P
from eop_tpu.models import init_model
from eop_tpu_torch.eval.evaluator_24p import Evaluator24P, polygon_rows_to_xyxy
from eop_tpu_torch.eval.postprocess import Detections
from eop_tpu_torch.exp import Exp24P
from eop_tpu_torch.utils.synth import (LabelOracle, label_detections,
                                       write_24p_dataset)
from eop_tpu_torch.utils.weights import state_dict_from_jax


def test_polygon_rows_to_xyxy_equals_jax():
    rows = np.random.RandomState(0).uniform(0, 50, (7, 29)).astype(np.float32)
    np.testing.assert_array_equal(polygon_rows_to_xyxy(rows), j_xyxy(rows))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Five 90x160 images: at 64 px the last batch of two is short."""
    root = tmp_path_factory.mktemp("eval24p")
    return write_24p_dataset(str(root), 5, (90, 160), seed=1)


def evaluators(files, size=(64, 64), batch=2):
    img_dir, lab_dir = files
    exp = Exp24P()
    exp.test_size, exp.num_classes, exp.data_num_workers = size, 3, 0
    exp.data_dir, exp.label_dir = img_dir, lab_dir
    ev = exp.get_evaluator(batch)
    jds = JDataset(img_dir, lab_dir, size, JTransform(50))
    jev = JEvaluator(JLoader(jds, batch_size=batch, shuffle=False,
                             num_workers=0), size, 0.01, 0.3, num_classes=3)
    return ev, jev


class Ordered:
    """A pure ``infer_fn`` giving the k-th distinct batch it sees the k-th
    entry of ``outputs`` (evaluators run their first batch twice)."""

    def __init__(self, outputs, wrap):
        self.outputs, self.wrap, self.seen = outputs, wrap, []

    def __call__(self, imgs):
        key = np.asarray(imgs).tobytes()
        if key not in self.seen:
            self.seen.append(key)
        rows, valid = self.outputs[self.seen.index(key)]
        return self.wrap(rows[: len(imgs)], valid[: len(imgs)])


def oracle_outputs(dataset, batch, max_det=10):
    """The labels of ``dataset`` as detection rows, batch by batch."""
    return [label_detections([dataset[i][1] for i in range(
        start, min(start + batch, len(dataset)))], max_det)
        for start in range(0, len(dataset), batch)]


def test_oracle_scores_ap_one_over_a_short_last_batch(files):
    ev, _ = evaluators(files)
    ap5095, ap50, summary = ev.evaluate(
        LabelOracle(ev.dataloader.dataset, "cpu"))
    assert ap50 == pytest.approx(1.0, abs=1e-6), summary
    assert ap5095 == pytest.approx(1.0, abs=1e-6), summary
    assert ev.timings["batches"] == 3 and ev.timings["images"] == 5
    outs = oracle_outputs(ev.dataloader.dataset, 2)
    assert ev.timings["detections"] == sum(int(v.sum()) for _, v in outs)


@pytest.mark.parametrize("seed", [0, 1])
def test_same_detections_give_jax_ap(files, seed):
    """Seeded detections near and far from the labels, random scores and
    classes, through both evaluators."""
    ev, jev = evaluators(files)
    rng = np.random.RandomState(seed)
    outs = []
    for rows, valid in oracle_outputs(ev.dataloader.dataset, 2, max_det=30):
        rows = rows.copy()
        rows[:, :, :26] += rng.normal(0, 2.0, rows[:, :, :26].shape)
        rows[:, :, 2:26] = np.abs(rows[:, :, 2:26])
        extra = ~valid & (rng.rand(*valid.shape) < 0.5)
        rows[extra, :2] = rng.uniform(5, 60, (extra.sum(), 2))
        rows[extra, 2:26] = rng.uniform(2, 15, (extra.sum(), 24))
        rows[:, :, 26] = rng.uniform(0.05, 1.0, rows.shape[:2])
        rows[:, :, 28] = np.where(rng.rand(*valid.shape) < 0.2,
                                  rng.randint(0, 3, valid.shape),
                                  rows[:, :, 28])
        outs.append((rows.astype(np.float32), valid | extra))
    got = ev.evaluate(Ordered(outs, lambda r, v: Detections(
        torch.from_numpy(r), torch.from_numpy(v))))
    want = jev.evaluate(Ordered(outs, lambda r, v: JDetections(
        rows=jnp.asarray(r), valid=jnp.asarray(v))))
    assert 0 < want[1] < 1
    assert got[0] == pytest.approx(want[0], abs=1e-12)
    assert got[1] == pytest.approx(want[1], abs=1e-12)
    assert got[2].splitlines()[1:] == want[2].splitlines()[1:]


def tiny(exp):
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, 3
    exp.test_size = (96, 96)
    # random-init scores sit near the squared 0.01 prior (1e-4)
    exp.test_conf = 5e-5
    return exp


class Recorder:
    def __init__(self, fn):
        self.fn, self.outputs = fn, []

    def __call__(self, imgs):
        out = self.fn(imgs)
        self.outputs.append((np.asarray(out.rows), np.asarray(out.valid)))
        return out


def test_slice_matches_jax_end_to_end(tmp_path):
    """Files -> loader -> letterbox -> JAX weights through the bridge ->
    forward -> postprocess -> COCO-24p AP, for 3 images already at 96 px
    (so both loaders hand over the same pixels), in one batch."""
    img_dir, lab_dir = write_24p_dataset(str(tmp_path), 3, (96, 96), seed=2)
    jexp = tiny(JaxExp24P())
    jmodel = jexp.get_model()
    variables = jax.tree_util.tree_map(np.asarray, init_model(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3))))
    exp = tiny(Exp24P())
    model = exp.get_model("cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)

    for e in (exp, jexp):
        e.data_dir, e.label_dir, e.data_num_workers = img_dir, lab_dir, 0
    ev, jev = exp.get_evaluator(3), jexp.get_evaluator(3)
    port = Recorder(exp.get_infer_fn(model, "cpu"))
    ref = Recorder(jexp.get_infer_fn(jmodel, variables))
    got, want = ev.evaluate(port), jev.evaluate(ref)
    assert len(port.outputs) == len(ref.outputs) == 2   # warm-up + timed
    (rows, valid), (j_rows, j_valid) = port.outputs[-1], ref.outputs[-1]
    assert j_valid.sum() > 0
    np.testing.assert_array_equal(valid, j_valid)
    np.testing.assert_allclose(rows[valid], j_rows[valid], atol=1e-4,
                               rtol=1e-4)
    assert got[0] == pytest.approx(want[0], abs=1e-3)
    assert got[1] == pytest.approx(want[1], abs=1e-3)
    # Exp24P.eval is the same evaluation
    again = exp.eval(model, ev)
    assert again[:2] == got[:2]
