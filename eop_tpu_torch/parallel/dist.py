"""Process-group plumbing (counterpart of ``eop_tpu/parallel/dist.py``).

``eop_tpu`` runs one process per host and lets XLA own the chips; the port
runs one process per GPU, the PyTorch idiom, on ``cuda:LOCAL_RANK``, with
NCCL on the card and gloo on the CPU:

* the accessors read the default process group (1 / 0 without one);
  ``get_local_rank`` / ``get_local_size`` read torchrun's ``LOCAL_RANK`` /
  ``LOCAL_WORLD_SIZE`` (0 / 1 without them: one process per host, as
  ``eop_tpu``'s ``--multi-host`` flags start it);
* :func:`all_gather` and :func:`gather` move arbitrary picklable objects of
  unequal size over a gloo side group made once per process (the
  reference's ``_get_global_gloo_group``), so that they never touch the
  card;
* :func:`init_distributed` starts the group from ``eop_tpu``'s flags
  (``--coordinator HOST:PORT --num-processes N --process-id I``) or from
  torchrun's environment, with an explicit timeout, and uses a group that
  already exists as it is.
"""

from __future__ import annotations

import datetime
import functools
import os
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "get_num_devices",
    "get_world_size",
    "get_rank",
    "get_local_rank",
    "get_local_size",
    "is_main_process",
    "synchronize",
    "all_gather",
    "all_reduce_sum",
    "gather",
    "in_rank_order",
    "shared_random_seed",
    "time_synchronized",
    "wait_device",
    "init_distributed",
    "rank_device",
    "under_torchrun",
]

# how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_num_devices() -> int:
    """Cards visible to this process (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if _initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if _initialized() else 0


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def get_local_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def is_main_process() -> bool:
    return get_rank() == 0


def rank_device(device) -> torch.device:
    """``cuda`` without an index -> this process's card, ``cuda:LOCAL_RANK``;
    any other device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", get_local_rank())
    return device


def _gloo_group():
    """The default group where it is gloo's, else a gloo group over the
    same ranks, made once per default group (a collective: every rank
    makes it at its first object collective)."""
    return _gloo_side_group(dist.group.WORLD)


@functools.lru_cache(maxsize=None)
def _gloo_side_group(world_group):
    if dist.get_backend(world_group) == "gloo":
        return world_group
    return dist.new_group(backend="gloo")


def synchronize() -> None:
    """Barrier over every rank (no-op in one process)."""
    if get_world_size() > 1:
        dist.barrier(group=_gloo_group())


def in_rank_order(fn: Callable[[], Any]) -> Any:
    """``fn()`` on every rank, one rank at a time in rank order (a barrier
    after each): for work every rank does that writes shared files, such
    as an evaluation's results files."""
    out = None
    for r in range(get_world_size()):
        if get_rank() == r:
            out = fn()
        synchronize()
    return out


def all_gather(data: Any) -> List[Any]:
    """Every rank's ``data`` (any picklable object, sizes may differ), in
    rank order, on every rank."""
    world = get_world_size()
    if world == 1:
        return [data]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, data, group=_gloo_group())
    return out


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Every rank's ``data`` in rank order on ``dst``; ``[]`` elsewhere."""
    world = get_world_size()
    if world == 1:
        return [data]
    rank = get_rank()
    out: Optional[List[Any]] = [None] * world if rank == dst else None
    dist.gather_object(data, out, dst=dst, group=_gloo_group())
    return out if rank == dst else []


def all_reduce_sum(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The sums over ``group``'s ranks of ``tensors`` (detached, one
    ``all_reduce`` of their concatenation in fp32, or float64 where one of
    them is), in the given shapes."""
    dtype = (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
             else torch.float32)
    flat = torch.cat([t.detach().to(dtype).reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.reshape(t.shape) for part, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def shared_random_seed() -> int:
    """One random seed, the same on every rank (rank 0's draw)."""
    seed = int(np.random.randint(2**31))
    return int(all_gather(seed)[0])


def wait_device(x=None) -> None:
    """Wait for the work queued on the card (``x``'s, else the current
    one's); nothing on the CPU."""
    device = getattr(x, "device", None)
    if device is not None and device.type != "cuda":
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def time_synchronized() -> float:
    """The wall clock once the card's queued work is done."""
    wait_device()
    return time.time()


def under_torchrun() -> bool:
    """Whether torchrun's environment names this process's rank and its
    rendezvous (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def init_distributed(device, coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     backend: Optional[str] = None) -> bool:
    """Start the default process group for ``device``: ``backend``, else
    NCCL on a card and gloo on the CPU (gloo also carries CUDA tensors, for
    ranks that share one card, which NCCL refuses).

    With ``coordinator`` (``HOST:PORT`` of rank 0), ``num_processes`` and
    ``process_id`` give the world size and this rank, as ``eop_tpu``'s
    ``--multi-host`` flags do; without them torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) does, and
    where it is missing this raises.  A group that exists already is used
    as it is.  On a card, ``cuda:LOCAL_RANK`` becomes the current device
    first.  Returns whether this call made the group (its caller then
    destroys it)."""
    if _initialized():
        return False
    device = rank_device(device)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"--process-id {process_id} is not in "
                             f"[0, {num_processes})")
        kw = dict(init_method=f"tcp://{coordinator}",
                  world_size=num_processes, rank=process_id)
    elif under_torchrun():
        kw = dict(init_method="env://")
    else:
        raise ValueError(
            "multi-process training needs --coordinator HOST:PORT "
            "--num-processes N --process-id I, or torchrun's environment "
            "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(backend, timeout=timeout, **kw)
    return True
