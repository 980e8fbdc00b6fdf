"""Batching for the file datasets (counterpart of
``eop_tpu/data/dataloading.py``), in PyTorch's idiom:
``torch.utils.data.DataLoader`` over the YOLO batch sampler, with
``default_collate``, which gives ``eop_tpu``'s batch structure: images
``[B, H, W, 3]``, labels ``[B, 50, 51]``, ``info_imgs`` as ``[hs, ws]``
and ids ``[B, 1]``.

Workers are spawned, never forked: a forked child of a process that holds a
CUDA context must not touch the card, and spawned ones start from a fresh
import that has none.  PyTorch's worker loop sets one intra-op thread in
each worker, which the host resize (a torch call) needs: several workers
with a full thread pool each would oversubscribe the host.  Batches come
back in pinned memory where there is a card, so the trainer's
``.to(device, non_blocking=True)`` is an asynchronous copy.  A worker ends
without the interpreter's teardown (see :class:`WorkerInit`).  The device
prefetcher comes with queue 3.
"""

from __future__ import annotations

import atexit
import os
import random
import uuid
from typing import Callable, Optional

import numpy as np
import torch
import torch.utils.data


def worker_init_reset_seed(worker_id: int) -> None:
    """A fresh random seed per worker."""
    seed = uuid.uuid4().int % 2**32
    random.seed(seed)
    np.random.seed(seed)


class WorkerInit:
    """A worker's start: ``fn(worker_id)`` where given, and an exit hook that
    ends the worker with ``os._exit(0)`` as soon as the interpreter begins to
    shut down.

    A loader dropped with batches in flight (the trainer's, whose sampler
    never ends) stops workers that may still be handing a batch over in
    their queue's feeder thread; on an H100 host (Python 3.12, PyTorch 2.11)
    the teardown of such a worker often aborted it ("terminate called
    without an active exception", SIGABRT), and the loader reported a dead
    worker.  The batch is discarded either way, and the worker has nothing
    to flush: its results went through the queue, its errors are sent as
    results.
    """

    def __init__(self, fn: Optional[Callable] = None):
        self.fn = fn

    def __call__(self, worker_id: int) -> None:
        atexit.register(os._exit, 0)
        if self.fn is not None:
            self.fn(worker_id)


def data_loader(dataset, batch_size: int = 1, batch_sampler=None,
                num_workers: int = 0,
                worker_init_fn: Optional[Callable] = None
                ) -> torch.utils.data.DataLoader:
    """A ``DataLoader`` in order over ``dataset`` (or over
    ``batch_sampler``'s batches) with ``default_collate``, spawned workers,
    and pinned batches where there is a card."""
    return torch.utils.data.DataLoader(
        dataset,
        batch_size=1 if batch_sampler is not None else batch_size,
        batch_sampler=batch_sampler,
        num_workers=num_workers,
        pin_memory=torch.cuda.is_available(),
        worker_init_fn=WorkerInit(worker_init_fn) if num_workers else None,
        multiprocessing_context="spawn" if num_workers else None,
    )
