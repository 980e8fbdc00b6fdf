"""Samplers (counterpart of ``eop_tpu/data/samplers.py``) as
``torch.utils.data`` samplers: the rank-strided infinite shuffled index
stream, which draws the same indices as ``eop_tpu``'s
(``np.random.default_rng(seed).permutation`` per pass), and the
``(mosaic, index)`` batches of the YOLO batch sampler."""

from __future__ import annotations

import itertools
from typing import Iterator, Optional

import numpy as np
import torch.utils.data

# groups indices into lists of ``batch_size``; ``len`` is ``n // batch_size``
# with ``drop_last`` and ``ceil(n / batch_size)`` without, as eop_tpu's
BatchSampler = torch.utils.data.BatchSampler


class InfiniteSampler(torch.utils.data.Sampler):
    """Infinite stream of shuffled indices; each rank takes
    ``indices[rank::world_size]``."""

    def __init__(self, size: int, shuffle: bool = True,
                 seed: Optional[int] = 0, rank: int = 0,
                 world_size: int = 1):
        if size <= 0:
            raise ValueError(f"an empty dataset has no index stream: {size}")
        self._size = size
        self._shuffle = shuffle
        self._seed = int(seed or 0)
        self._rank = rank
        self._world_size = world_size

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(
            self._infinite_indices(), self._rank, None, self._world_size)

    def _infinite_indices(self):
        rng = np.random.default_rng(self._seed)
        while True:
            if self._shuffle:
                yield from rng.permutation(self._size).tolist()
            else:
                yield from range(self._size)

    def __len__(self):
        return self._size // self._world_size


class YoloBatchSampler(BatchSampler):
    """Batches of ``(mosaic, index)`` tuples; flipping ``.mosaic`` turns the
    mosaic augmentation off mid-training."""

    def __init__(self, *args, mosaic: bool = True, input_dimension=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.mosaic = mosaic
        self.input_dimension = input_dimension

    def __iter__(self):
        for batch in super().__iter__():
            yield [(self.mosaic, idx) for idx in batch]
