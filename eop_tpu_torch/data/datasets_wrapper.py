"""Dataset base (counterpart of ``eop_tpu/data/datasets_wrapper.py``): a
``torch.utils.data.Dataset`` with a dynamic ``input_dim`` and the
``(mosaic, index)`` tuple-index protocol of the batch samplers.  The
concatenating datasets come with queue 3."""

from __future__ import annotations

from functools import wraps

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
