"""Detection datasets of fit-resized images (counterpart of
``eop_tpu/data/cached_dataset.py``): :func:`fit_resize`, and the base that
parses annotations once, pre-scales them to the training size, serves
images resized by the same ratio, and with ``cache`` backs the resized
images with an ``np.memmap`` file beside the data (built on the first run,
reused after).  Resizes go through :func:`resize_host` (one level of
``cv2.resize``)."""

from __future__ import annotations

import os
from multiprocessing.pool import ThreadPool
from typing import Any, List, Tuple

import numpy as np

from .datasets_wrapper import Dataset
from .transforms import resize_host

# one record per sample: (labels [N, 5+] pre-scaled, raw (h, w),
#                         resized (h, w), per-dataset metadata)
Record = Tuple[np.ndarray, Tuple[int, int], Tuple[int, int], Any]


def fit_resize(img: np.ndarray, img_size) -> Tuple[np.ndarray, float]:
    """Shrink or grow ``img`` by the largest ratio that fits ``img_size``."""
    r = min(img_size[0] / img.shape[0], img_size[1] / img.shape[1])
    return resize_host(img, (int(img.shape[0] * r), int(img.shape[1] * r))), r


class ResizedDetectionDataset(Dataset):
    """Base of the datasets whose samples are images fit-resized into
    ``img_size`` with annotations pre-scaled by the same ratio.  Subclasses
    fill ``annotations`` and give :meth:`load_image`, :meth:`_cache_path`
    and :meth:`sample_id`."""

    def __init__(self, img_size, preproc=None):
        super().__init__(img_size)
        self.img_size = img_size
        self.preproc = preproc
        self.annotations: List[Record] = []
        self.imgs = None  # memmap of resized images when caching is on

    def load_image(self, index: int) -> np.ndarray:
        """The raw BGR image of a sample."""
        raise NotImplementedError

    def _cache_path(self) -> str:
        raise NotImplementedError

    def sample_id(self, index: int):
        return index

    def __len__(self) -> int:
        return len(self.annotations)

    def fit_ratio(self, raw_hw) -> float:
        return min(self.img_size[0] / raw_hw[0], self.img_size[1] / raw_hw[1])

    def load_anno(self, index: int) -> np.ndarray:
        return self.annotations[index][0]

    def load_resized_img(self, index: int) -> np.ndarray:
        resized, _ = fit_resize(self.load_image(index), self.img_size)
        return resized

    def _cache_images(self):
        """Build (first run) and attach the memmap of resized images: every
        slot is ``img_size``-shaped, sample ``i`` lives in its top-left
        ``resized (h, w)``."""
        path = self._cache_path()
        shape = (len(self), *self.img_size[:2], 3)
        if not os.path.exists(path):
            store = np.memmap(path + ".building", shape=shape, dtype=np.uint8,
                              mode="w+")
            workers = min(8, os.cpu_count() or 1)
            with ThreadPool(workers) as pool:
                for i, resized in enumerate(
                        pool.imap(self.load_resized_img, range(len(self)))):
                    store[i, : resized.shape[0], : resized.shape[1]] = resized
            store.flush()
            del store
            os.replace(path + ".building", path)
        self.imgs = np.memmap(path, shape=shape, dtype=np.uint8, mode="r")

    def pull_item(self, index: int):
        labels, raw_hw, resized_hw, _ = self.annotations[index]
        if self.imgs is not None:
            img = self.imgs[index][: resized_hw[0], : resized_hw[1]].copy()
        else:
            img = self.load_resized_img(index)
        return img, labels.copy(), raw_hw, self.sample_id(index)

    @Dataset.mosaic_getitem
    def __getitem__(self, index: int):
        img, target, raw_hw, sid = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.input_dim)
        return img, target, raw_hw, sid
