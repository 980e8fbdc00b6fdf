"""24-point dataset and transforms over txt label files (counterpart of
``eop_tpu/data/coco24p.py``).

Label files: one txt per image, rows of 51 floats ``[cls, cx, cy,
24 x (x, y)]``, every coordinate normalized to the original image size.
Images are ``{stem}.jpg`` beside them and are read by content
(``image_io.imread``), so any format ``imread`` decodes may sit under that
name.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np

from .augment import preproc
from .cached_dataset import fit_resize
from .datasets_wrapper import Dataset
from .image_io import imread


class COCO24PDataset(Dataset):
    """COCO-24P dataset over per-image txt label files.

    All label rows load into RAM at construction; images are decoded and
    fit-resized per item.  Items are ``(image, labels, (h, w) of the raw
    image, [id])`` with the id the file stem as an integer.
    """

    def __init__(self, data_dir: str, label_dir: str, img_size=(640, 640),
                 preproc=None):
        super().__init__(img_size)
        self.data_dir = data_dir
        self.label_dir = label_dir
        self.img_size = img_size
        self.preproc = preproc

        self.coco24p_dict = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # np.loadtxt on empty files
            for txt in sorted(Path(label_dir).glob("*.txt")):
                self.coco24p_dict[txt.stem] = np.loadtxt(
                    txt, dtype=float, ndmin=2)
        self.image_list = [f"{stem}.jpg" for stem in self.coco24p_dict]

    def __len__(self):
        return len(self.image_list)

    def load_image(self, img_name: str) -> np.ndarray:
        return imread(os.path.join(self.data_dir, img_name))

    def pull_item(self, index):
        stem = Path(self.image_list[index]).stem
        raw = self.load_image(self.image_list[index])
        img, _ = fit_resize(raw, self.img_size)
        return img, self.coco24p_dict[stem], raw.shape[:2], np.array(
            [int(stem)])

    @Dataset.mosaic_getitem
    def __getitem__(self, index):
        img, target, img_info, img_id = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.img_size)
        return img, target, img_info, img_id


class TrainTransform24P:
    """De-normalize the 24p coordinates to the (fit-resized) image, letterbox,
    pad the rows to ``[max_labels, 51]``.  Like the reference, no flip and
    no HSV jitter."""

    def __init__(self, max_labels=50):
        self.max_labels = max_labels

    def __call__(self, image, targets, input_dim):
        if targets.shape[1] == 0:
            image, _ = preproc(image, input_dim)
            return image, np.zeros((self.max_labels, 51), dtype=np.float32)

        height_o, width_o, _ = image.shape
        boxes24p = targets[:, 1:].copy()
        labels24p = targets[:, 0].copy()
        boxes24p[:, 0::2] = boxes24p[:, 0::2] * width_o
        boxes24p[:, 1::2] = boxes24p[:, 1::2] * height_o

        image_t, r = preproc(image, input_dim)
        boxes24p *= r

        targets_t = np.hstack((labels24p[:, None], boxes24p))
        padded = np.zeros((self.max_labels, 51), dtype=np.float32)
        padded[: min(len(targets_t), self.max_labels)] = targets_t[
            : self.max_labels]
        return image_t, np.ascontiguousarray(padded, np.float32)


class ValTransform24P:
    """Letterbox only; also returns the padded uint8 image for display."""

    def __call__(self, img, res, input_size):
        img_f, _ = preproc(img, input_size)
        return img_f, np.zeros((1, 5), dtype=np.float32), img_f.astype(
            np.uint8)
