"""The port's 24p file data path on the CPU against the JAX package's: the
image reader against cv2, the letterbox and fit-resize, the dataset's items,
the samplers' streams and the exp's loader, batch for batch.

Tolerances: decoded pixels, labels, image sizes, ids and sampler streams
bit-equal; a resize at a ratio other than 1 within one level of cv2's
(``cv2.resize`` rounds fixed-point weights, the port's torch bilinear rounds
float ones), bit-equal at ratio 1."""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cv2

from eop_tpu.data.augment import preproc as j_preproc
from eop_tpu.data.cached_dataset import fit_resize as j_fit_resize
from eop_tpu.data.coco24p import COCO24PDataset as JDataset
from eop_tpu.data.coco24p import TrainTransform24P as JTransform
from eop_tpu.data.samplers import InfiniteSampler as JInfinite
from eop_tpu.data.samplers import YoloBatchSampler as JYolo
from eop_tpu.exp.yolox_24p_base import Exp24P as JaxExp24P
from eop_tpu_torch.data.augment import preproc
from eop_tpu_torch.data.cached_dataset import fit_resize
from eop_tpu_torch.data.coco24p import COCO24PDataset, TrainTransform24P
from eop_tpu_torch.data.dataloading import WorkerInit, data_loader
from eop_tpu_torch.data.image_io import image_size, imread
from eop_tpu_torch.data.samplers import InfiniteSampler, YoloBatchSampler
from eop_tpu_torch.exp import Exp24P
from eop_tpu_torch.utils.synth import write_24p_dataset


@pytest.mark.parametrize("ext", [".bmp", ".ppm"])
@pytest.mark.parametrize("hw", [(24, 32), (17, 31), (9, 30), (12, 29)])
def test_imread_is_cv2_imread_without_cv2(tmp_path, monkeypatch, ext, hw):
    """Odd widths pad BMP rows to 4 bytes; the name says .jpg, the content
    decides."""
    img = np.random.RandomState(hw[1]).randint(0, 256, (*hw, 3)).astype(
        np.uint8)
    path = str(tmp_path / "000000000001.jpg")
    assert cv2.imwrite(str(tmp_path / f"a{ext}"), img)
    os.replace(tmp_path / f"a{ext}", path)
    want = cv2.imread(path)
    monkeypatch.setitem(sys.modules, "cv2", None)   # no OpenCV from here on
    got = imread(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    assert image_size(path) == (hw[1], hw[0])


def test_imread_needs_cv2_for_other_formats(tmp_path, monkeypatch):
    """A format the port does not decode itself (TIFF; JPEG and PNG it
    does) goes to cv2 where it is installed and raises, naming the format,
    where it is not."""
    img = np.random.RandomState(0).randint(0, 256, (8, 10, 3)).astype(
        np.uint8)
    path = str(tmp_path / "a.jpg")
    assert cv2.imwrite(str(tmp_path / "a.tiff"), img)
    os.replace(tmp_path / "a.tiff", path)
    np.testing.assert_array_equal(imread(path), cv2.imread(path))  # via cv2
    assert image_size(path) == (10, 8)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="TIFF needs OpenCV"):
        imread(path)
    with pytest.raises(RuntimeError, match="needs OpenCV"):
        image_size(path)


@pytest.mark.parametrize("img_hw,size", [
    ((90, 160), (64, 64)),     # shrink, wide
    ((50, 70), (96, 96)),      # grow
    ((100, 60), (64, 48)),     # shrink, tall
    ((64, 40), (64, 64)),      # r = 1, canvas wider than the image
    ((64, 64), (64, 64)),      # identity
])
def test_preproc_and_fit_resize_match_jax(img_hw, size):
    img = np.random.RandomState(sum(img_hw)).randint(
        0, 256, (*img_hw, 3)).astype(np.uint8)
    for port, jax_fn in ((preproc, j_preproc), (fit_resize, j_fit_resize)):
        got, r = port(img, size)
        want, r_want = jax_fn(img, size)
        assert r == r_want
        assert got.shape == want.shape and got.dtype == want.dtype
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
        assert diff <= (0 if r == 1.0 else 1), (port.__name__, diff)


@pytest.fixture(scope="module")
def wide_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("wide")
    return write_24p_dataset(str(root), 4, (90, 160))


@pytest.mark.parametrize("size", [(64, 64), (96, 128)])
def test_dataset_items_match_jax(wide_files, size):
    img_dir, lab_dir = wide_files
    ds = COCO24PDataset(img_dir, lab_dir, size, TrainTransform24P(50))
    jds = JDataset(img_dir, lab_dir, size, JTransform(50))
    assert len(ds) == len(jds) == 4 and ds.image_list == jds.image_list
    for i in range(len(ds)):
        img, labels, info, ids = ds[i]
        j_img, j_labels, j_info, j_ids = jds[i]
        assert img.shape == j_img.shape == (*size, 3)
        assert img.dtype == j_img.dtype == np.float32
        assert np.abs(img - j_img).max() <= 1.0
        np.testing.assert_array_equal(labels, j_labels)
        assert labels.shape == (50, 51) and labels.dtype == np.float32
        assert tuple(info) == tuple(j_info) == (90, 160)
        np.testing.assert_array_equal(ids, j_ids)
        # the tuple index of the batch samplers
        np.testing.assert_array_equal(ds[(False, i)][1], labels)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("world", [1, 2])
def test_sampler_streams_match_jax(seed, world):
    for rank in range(world):
        s = InfiniteSampler(11, seed=seed, rank=rank, world_size=world)
        j = JInfinite(11, seed=seed, rank=rank, world_size=world)
        assert isinstance(s, torch.utils.data.Sampler)
        assert len(s) == len(j) == 11 // world
        assert (list(itertools.islice(iter(s), 40))
                == list(itertools.islice(iter(j), 40)))
        for drop_last in (False, True):
            b = YoloBatchSampler(s, 3, drop_last, mosaic=False)
            jb = JYolo(j, 3, drop_last, mosaic=False)
            assert len(b) == len(jb)
            assert (list(itertools.islice(iter(b), 9))
                    == list(itertools.islice(iter(jb), 9)))


@pytest.fixture(scope="module")
def square_files(tmp_path_factory):
    """Images already at the input size: the resizes are identities, so the
    two loaders' images agree bit for bit."""
    root = tmp_path_factory.mktemp("square")
    return write_24p_dataset(str(root), 5, (64, 64), seed=3)


@pytest.mark.parametrize("workers", [0, 2])
def test_exp_loader_matches_jax_batch_for_batch(square_files, workers):
    img_dir, lab_dir = square_files
    exps = (Exp24P(), JaxExp24P())
    for e in exps:
        e.input_size, e.data_num_workers, e.seed = (64, 64), workers, 5
        e.data_dir, e.label_dir = img_dir, lab_dir
    loader = exps[0].get_data_loader(2)
    j_loader = exps[1].get_data_loader(2)
    assert isinstance(loader, torch.utils.data.DataLoader)
    assert len(loader) == len(j_loader) == 3
    it, j_it = iter(loader), iter(j_loader)
    try:
        for _ in range(3):
            (imgs, labels, (hs, ws), ids) = next(it)
            j_imgs, j_labels, (j_hs, j_ws), j_ids = next(j_it)
            assert imgs.shape == (2, 64, 64, 3) and imgs.dtype == torch.float32
            assert labels.shape == (2, 50, 51)
            np.testing.assert_array_equal(imgs.numpy(), j_imgs)
            np.testing.assert_array_equal(labels.numpy(), j_labels)
            np.testing.assert_array_equal(hs.numpy(), j_hs)
            np.testing.assert_array_equal(ws.numpy(), j_ws)
            np.testing.assert_array_equal(ids.numpy(), j_ids)
    finally:
        del it
        j_loader.shutdown()


@pytest.mark.parametrize("size", [(64, 64), (48, 80)])
def test_val_transform_and_data_input_match_jax(wide_files, size):
    """ValTransform24P (letterbox, padded uint8 copy) and
    Exp24P.get_data_input, one level of cv2's resize, square and not."""
    from eop_tpu.data.coco24p import ValTransform24P as JVal
    from eop_tpu_torch.data.coco24p import ValTransform24P

    path = os.path.join(wide_files[0], sorted(os.listdir(wide_files[0]))[0])
    img = imread(path)
    got, got_lab, got_pad = ValTransform24P()(img, None, size)
    want, want_lab, want_pad = JVal()(img, None, size)
    assert got.shape == want.shape == (*size, 3) and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1.0
    assert np.abs(got_pad.astype(int) - want_pad.astype(int)).max() <= 1
    np.testing.assert_array_equal(got_lab, want_lab)

    exp, j_exp = Exp24P(), JaxExp24P()
    exp.test_size = j_exp.test_size = size
    padded, r, raw = exp.get_data_input(path)
    j_padded, j_r, j_raw = j_exp.get_data_input(path)
    assert r == j_r and padded.shape == j_padded.shape == (1, *size, 3)
    assert np.abs(padded - j_padded).max() <= 1.0
    np.testing.assert_array_equal(raw, j_raw)


def test_loader_workers_end_without_the_interpreters_teardown():
    """WorkerInit runs the given init, then ends its process with
    ``os._exit(0)`` as the interpreter starts to shut down, whatever the exit
    code was: a dropped loader's workers skip the teardown that aborted them
    on an H100 host."""
    code = ("import sys\n"
            "from eop_tpu_torch.data.dataloading import WorkerInit\n"
            "seen = []\n"
            "WorkerInit(seen.append)(3)\n"
            "assert seen == [3], seen\n"
            "print('init ran', flush=True)\n"
            "sys.exit(5)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=root))
    assert r.stdout == "init ran\n", r.stderr
    assert r.returncode == 0
    dl = data_loader(list(range(4)), batch_size=2, num_workers=2)
    assert isinstance(dl.worker_init_fn, WorkerInit)
    assert data_loader(list(range(4)), batch_size=2).worker_init_fn is None
