"""Dataset base (counterpart of ``eop_tpu/data/datasets_wrapper.py``): a
``torch.utils.data.Dataset`` with a dynamic ``input_dim`` and the
``(mosaic, index)`` tuple-index protocol of the batch samplers, and the
concatenating datasets: ``ConcatDataset`` (negative indices, ``pull_item``
and ``input_dim`` passed through) and ``MixConcatDataset`` (the tuple
indices passed on to the member dataset)."""

from __future__ import annotations

import bisect
from functools import wraps
from typing import Sequence

import torch.utils.data


class Dataset(torch.utils.data.Dataset):
    """Base dataset with on-the-fly ``input_dim`` resizing support."""

    def __init__(self, input_dimension, mosaic: bool = True):
        self.__input_dim = tuple(input_dimension[:2])
        self.enable_mosaic = mosaic

    @property
    def input_dim(self):
        if hasattr(self, "_input_dim"):
            return self._input_dim
        return self.__input_dim

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, index):  # pragma: no cover - abstract
        raise NotImplementedError

    @staticmethod
    def mosaic_getitem(getitem_fn):
        """Route ``(mosaic, index)`` tuple indices: set the flag, unwrap."""

        @wraps(getitem_fn)
        def wrapper(self, index):
            if not isinstance(index, int):
                self.enable_mosaic = index[0]
                index = index[1]
            return getitem_fn(self, index)

        return wrapper


class ConcatDataset(Dataset):
    """``datasets`` one after another, with ``pull_item`` passed through and
    the first one's ``input_dim``."""

    def __init__(self, datasets: Sequence):
        assert datasets, "datasets should not be empty"
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)
        if hasattr(self.datasets[0], "input_dim"):
            self._input_dim = self.datasets[0].input_dim
        super().__init__(getattr(self.datasets[0], "input_dim", (416, 416)))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx: int):
        """(member dataset, index in it) of ``idx``, which may be
        negative."""
        if idx < 0:
            if -idx > len(self):
                raise ValueError(
                    "absolute value of index should not exceed dataset length")
            idx = len(self) + idx
        di = bisect.bisect_right(self.cumulative_sizes, idx)
        return di, idx if di == 0 else idx - self.cumulative_sizes[di - 1]

    def __getitem__(self, idx):
        di, si = self._locate(idx)
        return self.datasets[di][si]

    def pull_item(self, idx):
        di, si = self._locate(idx)
        return self.datasets[di].pull_item(si)


class MixConcatDataset(ConcatDataset):
    """A :class:`ConcatDataset` that takes the batch samplers' ``(mosaic,
    index, ...)`` tuples and hands the member its own index in them."""

    def __getitem__(self, index):
        if isinstance(index, int):
            di, si = self._locate(index)
            return self.datasets[di][si]
        di, si = self._locate(index[1])
        return self.datasets[di][(index[0], si, *index[2:])]
