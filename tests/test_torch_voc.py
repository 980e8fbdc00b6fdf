"""PASCAL VOC in the port against ``eop_tpu``: the dataset over a seeded
devkit (``utils/synth.write_voc_devkit``, 96x128 JPEG, both years), the
VOC AP protocol, the comp4 files, ``VOCEvaluator`` and the VOC exp file,
which the port reads without importing it.  Bounds: annotations, AP and
mAP equal (``voc_eval``'s curves to 1e-12); images bit-equal where the
port's resize is swapped for cv2's, else within the one level
``resize_host`` differs by (tests/test_torch_bbox_data.py)."""

import contextlib
import importlib
import io
import os
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from eop_tpu.data.augment import ValTransform as JValTransform  # noqa: E402
from eop_tpu.data.dataloading import DataLoader as JDataLoader  # noqa: E402
from eop_tpu.data.voc import VOCDetection as JVOCDetection  # noqa: E402
from eop_tpu.eval import Detections as JDetections  # noqa: E402
from eop_tpu.eval.voc_evaluator import VOCEvaluator as JVOCEvaluator  # noqa: E402
from eop_tpu.exp import get_exp as j_get_exp  # noqa: E402
from eop_tpu_torch.data import cached_dataset  # noqa: E402
from eop_tpu_torch.data.augment import ValTransform  # noqa: E402
from eop_tpu_torch.data.dataloading import data_loader  # noqa: E402
from eop_tpu_torch.data.voc import VOCDetection  # noqa: E402
from eop_tpu_torch.data.voc_classes import VOC_CLASSES  # noqa: E402
from eop_tpu_torch.eval import voc_eval as ve  # noqa: E402
from eop_tpu_torch.eval.postprocess import Detections  # noqa: E402
from eop_tpu_torch.eval.voc_evaluator import VOCEvaluator  # noqa: E402
from eop_tpu_torch.exp import Exp, get_exp  # noqa: E402
from eop_tpu_torch.utils.synth import LabelOracle, write_voc_devkit  # noqa: E402

# eop_tpu.eval exports the function under the module's name
jve = importlib.import_module("eop_tpu.eval.voc_eval")
ROOT = Path(__file__).resolve().parents[1]
VOC_EXP = ROOT / "exps" / "example" / "yolox_voc" / "yolox_voc_s.py"
SIZE = (64, 64)
HW = (96, 128)
TRAINVAL = [("2007", "trainval"), ("2012", "trainval")]
TEST = [("2007", "test")]


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
def voc_root(tmp_path_factory):
    """The folder of a seeded VOCdevkit: 4 trainval images a year, 8 test
    images (every class in 2007's test split)."""
    root = tmp_path_factory.mktemp("voc")
    write_voc_devkit(str(root), n_trainval=4, n_test=8, hw=HW, seed=3)
    return root


def devkit_copy(voc_root, tmp_path, name):
    """A devkit of one's own: evaluation writes results/ and the annotation
    cache into it."""
    return shutil.copytree(voc_root / "VOCdevkit", tmp_path / name)


def test_devkit_layout(voc_root):
    """Both years with trainval and test lists, 1-based boxes inside the
    image, difficult objects, every class in VOC2007 test."""
    devkit = voc_root / "VOCdevkit"
    for year in ("2007", "2012"):
        main = devkit / f"VOC{year}" / "ImageSets" / "Main"
        assert sorted(os.listdir(main)) == ["test.txt", "trainval.txt"]
    recs = [ve.parse_rec(str(p)) for p in sorted(
        (devkit / "VOC2007" / "Annotations").glob("*.xml"))]
    objs = [o for r in recs for o in r]
    assert any(o["difficult"] for o in objs)
    assert {o["pose"] for o in objs} > {"Unspecified"}
    for o in objs:
        x1, y1, x2, y2 = o["bbox"]
        assert 1 <= x1 < x2 <= HW[1] and 1 <= y1 < y2 <= HW[0]
    stems = (devkit / "VOC2007" / "ImageSets" / "Main" / "test.txt"
             ).read_text().split()
    test = [o for s in stems for o in ve.parse_rec(
        str(devkit / "VOC2007" / "Annotations" / f"{s}.xml"))]
    assert {o["name"] for o in test if not o["difficult"]} == set(VOC_CLASSES)


def test_records_equal_eop_tpu(voc_root):
    """Ids, the pre-scaled annotation records (difficult objects kept) and
    the raw and resized sizes equal."""
    devkit = str(voc_root / "VOCdevkit")
    port = VOCDetection(devkit, TRAINVAL, img_size=SIZE)
    ref = JVOCDetection(devkit, TRAINVAL, img_size=SIZE)
    assert port.ids == ref.ids and len(port) == 8
    assert port._year == ref._year == "2012"
    for (rows, hw, rhw, meta), (jrows, jhw, jrhw, jmeta) in zip(
            port.annotations, ref.annotations):
        np.testing.assert_array_equal(rows, jrows)
        assert (hw, rhw, meta) == (jhw, jrhw, jmeta) and hw == HW


@pytest.mark.parametrize("resize", ["cv2", "resize_host"])
def test_images_and_val_items_equal_eop_tpu(voc_root, resize, monkeypatch):
    """The port's decoder gives cv2.imread's bytes; ``pull_item`` and the
    ``ValTransform`` items are bit-equal with cv2's resize swapped in, and
    within one level through the port's own."""
    devkit = str(voc_root / "VOCdevkit")
    if resize == "cv2":
        def cv2_resize(img, hw):
            return cv2.resize(img, (hw[1], hw[0]),
                              interpolation=cv2.INTER_LINEAR)

        from eop_tpu_torch.data import augment

        for module in (augment, cached_dataset):
            monkeypatch.setattr(module, "resize_host", cv2_resize)
    port = VOCDetection(devkit, TEST, img_size=SIZE, preproc=ValTransform())
    ref = JVOCDetection(devkit, TEST, img_size=SIZE,
                        preproc=JValTransform())
    tol = 0 if resize == "cv2" else 1
    for i in range(len(port)):
        np.testing.assert_array_equal(port.load_image(i), ref.load_image(i))
        for got, want in ((port.pull_item(i), ref.pull_item(i)),
                          (port[i], ref[i])):
            assert np.abs(got[0].astype(np.float64) - want[0]).max() <= tol
            np.testing.assert_array_equal(got[1], want[1])
            assert tuple(got[2]) == tuple(want[2]) and got[3] == want[3]


def test_parse_rec_and_voc_ap_equal_eop_tpu(voc_root):
    """Every annotation file parsed alike (pose, truncated, difficult), and
    voc_ap of 50 seeded PR curves in both metrics to 1e-12."""
    for path in sorted((voc_root / "VOCdevkit").glob("VOC*/Annotations/*")):
        assert ve.parse_rec(str(path)) == jve.parse_rec(str(path))
    rng = np.random.RandomState(4)
    for _ in range(50):
        n = rng.randint(1, 40)
        rec = np.sort(rng.uniform(0, 1, n))
        prec = rng.uniform(0, 1, n)
        for metric in (True, False):
            assert ve.voc_ap(rec, prec, metric) == pytest.approx(
                jve.voc_ap(rec, prec, metric), abs=1e-12)


def noisy_detections(devkit: Path, stems, seed: int = 5):
    """Per class, ``stem score x1 y1 x2 y2`` lines: each object found with
    seeded box noise, some twice (duplicates), tied and random scores, and
    false positives."""
    rng = np.random.RandomState(seed)
    lines = {c: [] for c in VOC_CLASSES}
    for stem in stems:
        for o in ve.parse_rec(str(devkit / "Annotations" / f"{stem}.xml")):
            for _ in range(1 + (rng.rand() < 0.3)):
                if rng.rand() < 0.15:
                    continue
                box = np.array(o["bbox"], float) + rng.randn(4) * 3
                score = 0.5 if rng.rand() < 0.2 else rng.uniform(0.05, 1)
                lines[o["name"]].append(
                    f"{stem} {score:.3f} " + " ".join(f"{v:.1f}" for v in box))
        for _ in range(2):
            x, y = rng.uniform(0, 80, 2)
            lines[VOC_CLASSES[rng.randint(20)]].append(
                f"{stem} {rng.uniform(0, 1):.3f} {x:.1f} {y:.1f} "
                f"{x + 30:.1f} {y + 20:.1f}")
    return lines


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_eval_equal_eop_tpu_at_every_iou(voc_root, tmp_path, use_07):
    """Seeded noisy detections of every class at IoU 0.5 ... 0.95: recall,
    precision and AP to 1e-12 (each side with its own annotation
    cache)."""
    devkit = voc_root / "VOCdevkit" / "VOC2007"
    listing = devkit / "ImageSets" / "Main" / "test.txt"
    detpath = str(tmp_path / "det_{}.txt")
    for cls, lines in noisy_detections(devkit, listing.read_text().split()
                                       ).items():
        Path(detpath.format(cls)).write_text("".join(s + "\n" for s in lines))
    anno = str(devkit / "Annotations" / "{:s}.xml")
    aps = []
    for iou in np.arange(0.5, 0.951, 0.05):
        for cls in VOC_CLASSES:
            got = ve.voc_eval(detpath, anno, str(listing), cls,
                              str(tmp_path / "port_cache"), iou, use_07)
            want = jve.voc_eval(detpath, anno, str(listing), cls,
                                str(tmp_path / "ref_cache"), iou, use_07)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
            aps.append(got[2])
    assert 0.05 < np.mean(aps) < 0.95


def fixed_detections(dataset, seed: int = 6):
    """One ``[1, 300, 7]`` batch a test image: the annotations (in the
    letterboxed pixels) with seeded noise and scores, and false
    positives."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(len(dataset)):
        rec = dataset.load_anno(i)
        n = len(rec)
        rows = np.zeros((1, 300, 7), np.float32)
        valid = np.zeros((1, 300), bool)
        rows[0, :n, :4] = rec[:, :4] + rng.randn(n, 4) * 1.5
        rows[0, :n, 4:6] = rng.uniform(0.3, 1, (n, 2))
        rows[0, :n, 6] = rec[:, 4]
        rows[0, n:n + 2, :4] = [[3, 3, 20, 16]] * 2
        rows[0, n:n + 2, 4:7] = [0.6, 0.5, 7]
        valid[0, :n + 2] = True
        out.append((rows, valid))
    return out


class Replay:
    """An ``infer_fn`` that answers batch k (in the order first seen) with
    ``batches[k]``: pure, as the evaluators need (they repeat the first
    batch)."""

    def __init__(self, batches, wrap):
        self.batches, self.wrap, self.seen = batches, wrap, {}

    def __call__(self, imgs):
        key = hash(np.asarray(imgs).tobytes())
        if key not in self.seen:
            self.seen[key] = self.wrap(*self.batches[len(self.seen)])
        return self.seen[key]


def test_voc_evaluator_equal_eop_tpu_and_comp4_bytes(voc_root, tmp_path):
    """The same detections through both evaluators (each on a devkit of
    its own): equal (mAP50:95, mAP50), byte-equal comp4 files and equal PR
    curves; the label oracle scores 1 on both metrics."""
    port_dir = str(devkit_copy(voc_root, tmp_path, "port"))
    ref_dir = str(devkit_copy(voc_root, tmp_path, "ref"))
    port_ds = VOCDetection(port_dir, TEST, img_size=SIZE,
                           preproc=ValTransform())
    ref_ds = JVOCDetection(ref_dir, TEST, img_size=SIZE,
                           preproc=JValTransform())
    dets = fixed_detections(port_ds)
    port = VOCEvaluator(data_loader(port_ds, batch_size=1), SIZE, 0.01, 0.65,
                        20)
    ref = JVOCEvaluator(JDataLoader(ref_ds, batch_size=1, shuffle=False),
                        SIZE, 0.01, 0.65, 20)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = port.evaluate(Replay(dets, lambda r, v: Detections(
            torch.from_numpy(r), torch.from_numpy(v))))
        want = ref.evaluate(Replay(dets, JDetections))
    assert got[:2] == want[:2] and 0.1 < got[0] < got[1] < 1
    assert "Average forward time per batch" in got[2]
    # each evaluation prints every class's AP and the mean at IoU 0.5
    assert out.getvalue().count("AP for ") == 40
    assert out.getvalue().count("Mean AP = ") == 2
    results = Path("results") / "VOC2007" / "Main"
    for cls in VOC_CLASSES:
        name = f"comp4_det_test_{cls}.txt"
        assert (Path(port_dir) / results / name).read_bytes() == (
            Path(ref_dir) / results / name).read_bytes()
    port_ds.evaluate_detections(port_all_boxes(port, dets),
                                str(tmp_path / "port_pr"))
    ref_ds.evaluate_detections(port_all_boxes(port, dets),
                               str(tmp_path / "ref_pr"))
    for cls in VOC_CLASSES:
        a = (tmp_path / "port_pr" / f"{cls}_pr.pkl").read_bytes()
        assert a == (tmp_path / "ref_pr" / f"{cls}_pr.pkl").read_bytes()

    oracle = VOCEvaluator(data_loader(port_ds, batch_size=3), SIZE, 0.01,
                          0.65, 20)
    with contextlib.redirect_stdout(io.StringIO()):
        m5095, m50, _ = oracle.evaluate(LabelOracle(port_ds, "cpu"))
    assert m5095 == pytest.approx(1.0) and m50 == pytest.approx(1.0)
    assert oracle.timings["images"] == 8 and oracle.timings["batches"] == 3


def port_all_boxes(evaluator, dets):
    """``all_boxes[class][image]`` of the fixed detections, as the port's
    conversion makes them (letterboxed at SIZE from HW)."""
    all_boxes = [[None] * len(dets) for _ in VOC_CLASSES]
    info = [torch.tensor([HW[0]]), torch.tensor([HW[1]])]
    for i, (rows, valid) in enumerate(dets):
        boxes, cls, scores = evaluator.convert_to_voc_format(
            rows, valid, info, torch.tensor([i]))[i]
        for c in range(len(VOC_CLASSES)):
            m = cls == c
            all_boxes[c][i] = np.hstack((boxes[m], scores[m][:, None])
                                        ).astype(np.float32)
    return all_boxes


def test_voc_exp_file_matches_eop_tpu(voc_root):
    """The VOC exp file read (not imported): every attribute both exps have
    is equal; the loaders hold the same splits, and the evaluators are
    VOC's."""
    exp, ref = get_exp(str(VOC_EXP)), j_get_exp(str(VOC_EXP))
    assert type(exp) is Exp and exp.data_kind == "voc"
    shared = set(vars(exp)) & set(vars(ref))
    assert {"depth", "width", "num_classes", "warmup_epochs",
            "exp_name"} <= shared
    for k in shared:
        assert getattr(exp, k) == getattr(ref, k), k
    assert (exp.depth, exp.width, exp.num_classes) == (0.33, 0.50, 20)
    for e in (exp, ref):
        e.data_dir, e.data_num_workers = str(voc_root), 0
        e.input_size = e.test_size = SIZE
    ev, jev = exp.get_evaluator(2), ref.get_evaluator(2)
    assert type(ev).__name__ == type(jev).__name__ == "VOCEvaluator"
    ds, jds = ev.dataloader.dataset, jev.dataloader.dataset
    assert type(ds) is VOCDetection and ds.image_set == jds.image_set == TEST
    assert ds.ids == jds.ids and ds.root == jds.root
    loader = exp.get_data_loader(2, no_aug=True)
    jloader = ref.get_data_loader(2, is_distributed=False, no_aug=True)
    inner, jinner = exp.dataset._dataset, ref.dataset._dataset
    assert type(inner) is VOCDetection and inner.ids == jinner.ids
    assert inner.image_set == jinner.image_set == TRAINVAL
    assert len(loader) == len(jloader)


VOC_TEXT = VOC_EXP.read_text()


@pytest.mark.parametrize("edit,line", [
    # an extra method after the four
    (lambda t: t + "\n    def get_model(self):\n        return None\n", 74),
    # a changed body: another max_labels
    (lambda t: t.replace("max_labels=50", "max_labels=100"), 19),
    # image_sets that are not a literal
    (lambda t: t.replace('image_sets=[("2007", "test")]',
                         "image_sets=self.sets"), 36),
    # another evaluator
    (lambda t: t.replace("VOCEvaluator(\n", "COCOEvaluator(\n").replace(
        "import VOCEvaluator", "import COCOEvaluator"), 61),
    # a statement added to _devkit_dir
    (lambda t: t.replace('        return os.path.join(self.data_dir or',
                         '        print(1)\n        return os.path.join('
                         'self.data_dir or'), 16),
])
def test_edited_voc_exp_file_raises_naming_file_and_line(tmp_path, edit,
                                                         line):
    text = edit(VOC_TEXT)
    assert text != VOC_TEXT
    path = tmp_path / "yolox_voc_s.py"
    path.write_text(text)
    with pytest.raises(ValueError, match=rf"{path}:{line}: method"):
        get_exp(str(path))


def test_voc_exp_file_without_one_method_raises(tmp_path):
    """Three of the four VOC methods are not a VOC exp: it raises, naming
    the class's line."""
    start = VOC_TEXT.index("    def get_evaluator")
    path = tmp_path / "yolox_voc_s.py"
    path.write_text(VOC_TEXT[:start].rstrip() + "\n")
    with pytest.raises(ValueError, match=rf"{path}:8: the VOC methods"):
        get_exp(str(path))


TINY = ["depth", "0.33", "width", "0.25", "input_size", "(64,64)",
        "test_size", "(64,64)", "data_num_workers", "0"]


def test_voc_command_lines_train_with_accum_and_eval(voc_root, tmp_path,
                                                     capsys):
    """``tools.train -f yolox_voc_s.py --accum 2`` over the devkit on the
    CPU (a mosaic epoch, the no-aug switch, an L1 epoch, each scored by VOC
    mAP), then ``tools.eval -f`` on its checkpoint: the 20 per-class AP
    lines, the forward / NMS split per batch and the AP line."""
    from eop_tpu_torch.tools import eval as eval_cli
    from eop_tpu_torch.tools import train as train_cli

    data_dir = str(devkit_copy(voc_root, tmp_path, "VOCdevkit").parent)
    out = str(tmp_path / "out")
    train_cli.main(["-f", str(VOC_EXP), "-b", "4", "--accum", "2",
                    "--data-dir", data_dir, "--device", "cpu"] + TINY
                   + ["max_epoch", "2", "no_aug_epochs", "0",
                      "eval_interval", "1", "print_interval", "1",
                      "multiscale_range", "0", "output_dir", out])
    run_dir = Path(out) / "yolox_voc_s"
    log = (run_dir / "train_log.txt").read_text()
    assert log.count("AP50:95=") == 2 and "No mosaic aug now" in log
    assert log.count("iter: 2/2") == 2  # 8 trainval images, batch 4
    assert (run_dir / "latest_ckpt.pth").exists()
    capsys.readouterr()
    ap50_95, ap50 = eval_cli.main(
        ["-f", str(VOC_EXP), "-c", str(run_dir / "latest_ckpt.pth"), "-b",
         "3", "--data-dir", data_dir, "--device", "cpu"] + TINY
        + ["test_conf", "1e-3"])
    printed = capsys.readouterr().out
    assert printed.count("AP for ") == 20 and "Mean AP = " in printed
    assert "Average forward time per batch" in printed
    assert "Average NMS time per batch" in printed
    assert re.search(r"AP50:95 = [0-9.]+  AP50 = [0-9.]+", printed)
    assert 0.0 <= ap50_95 <= ap50 <= 1.0
