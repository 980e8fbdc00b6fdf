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
  already exists as it is;
* :func:`make_mesh` lays the ranks out as ``eop_tpu``'s ``make_mesh`` lays
  out its devices, ``(data, space, model)`` (``--spatial``, ``--tensor``),
  and makes the process groups of each axis (:class:`Mesh`).
"""

from __future__ import annotations

import datetime
import functools
import os
import time
import socket
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

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
    "Mesh",
    "check_layout",
    "make_mesh",
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


class Mesh(NamedTuple):
    """This rank's place in a ``(data, space, model)`` layout of the ranks
    (``eop_tpu``'s ``make_mesh(spatial=, tensor=)``): the axes' sizes, this
    rank's index on each, and the process groups it belongs to: ``data``
    (the ranks holding other images, same space and model index),
    ``space`` (the ranks holding other rows of the same images), ``model``
    (the ranks holding other channel slices of the same rows) and
    ``data_space`` (data x space: the ranks of one model index).  A group
    of one rank is ``None``: that axis has nothing to reduce."""

    data_size: int = 1
    spatial: int = 1
    tensor: int = 1
    data_rank: int = 0
    space_rank: int = 0
    model_rank: int = 0
    data: Optional[Any] = None
    space: Optional[Any] = None
    model: Optional[Any] = None
    data_space: Optional[Any] = None


def check_layout(world: int, spatial: int = 1, tensor: int = 1,
                 hosts: Optional[Sequence] = None) -> None:
    """Raise ``ValueError`` with ``make_mesh``'s messages where ``world``
    ranks do not split into ``spatial x tensor`` groups, or where such a
    group (a data row's space and model ranks) holds ranks of more than
    one host (``hosts[r]``: rank r's host): the ranks of one image must
    share a host, as ``eop_tpu``'s inner mesh axes must not cross one."""
    if spatial < 1 or tensor < 1:
        raise ValueError(f"spatial={spatial} x tensor={tensor}: the axes "
                         "need at least one rank each")
    inner = spatial * tensor
    if world % inner:
        raise ValueError(f"{world} devices do not split into "
                         f"spatial={spatial} x tensor={tensor}")
    if hosts is None or inner == 1:
        return
    for start in range(0, world, inner):
        row = list(range(start, start + inner))
        on = sorted({hosts[r] for r in row})
        if len(on) > 1:
            raise ValueError(
                f"spatial={spatial} x tensor={tensor}: inner group {row} "
                f"spans hosts {on}; the space/model axes must not cross "
                "hosts")


def rank_hosts(world: int) -> List[Any]:
    """Each rank's host: ``rank // LOCAL_WORLD_SIZE`` where torchrun sets
    it (ranks are numbered host after host), else each rank's host name
    (an object collective)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return [r // get_local_size() for r in range(world)]
    return all_gather(socket.gethostname())


def _groups(world: int, members: Callable[[int], List[int]], rank: int):
    """Every group of ranks ``members(i)`` (``i`` from 0 until a rank's
    group repeats), made on every rank in one order as ``new_group``
    requires; returns the one holding ``rank`` (``None`` where groups have
    one rank)."""
    seen, mine = set(), None
    for r in range(world):
        ranks = tuple(members(r))
        if ranks in seen:
            continue
        seen.add(ranks)
        if len(ranks) == 1:
            continue
        if len(ranks) == world:
            return dist.group.WORLD
        g = dist.new_group(list(ranks))
        if rank in ranks:
            mine = g
    return mine


def make_mesh(spatial: int = 1, tensor: int = 1) -> Mesh:
    """The ranks of the default process group laid out as ``eop_tpu``'s
    ``make_mesh`` lays out its devices, ``devices.reshape(-1, spatial,
    tensor)``: rank ``r`` is ``(data, space, model) = (r // (S T),
    r // T % S, r % T)``, data-major.  Every rank must call it, with the
    same arguments (it makes the groups).  Without a process group the
    world is one rank: ``spatial=2`` raises, as ``make_mesh`` does on one
    device.  Raises where the ranks do not split or a data row's ranks
    span hosts (:func:`check_layout`)."""
    world, rank = get_world_size(), get_rank()
    check_layout(world, spatial, tensor,
                 rank_hosts(world) if world > 1 else None)
    s, t = spatial, tensor
    d = world // (s * t)
    if world == 1:
        return Mesh()

    def coords(r):
        return r // (s * t), r // t % s, r % t

    def at(dd, ss, tt):
        return (dd * s + ss) * t + tt

    groups = [
        _groups(world, lambda r: [at(x, coords(r)[1], coords(r)[2])
                                  for x in range(d)], rank),
        _groups(world, lambda r: [at(coords(r)[0], x, coords(r)[2])
                                  for x in range(s)], rank),
        _groups(world, lambda r: [at(coords(r)[0], coords(r)[1], x)
                                  for x in range(t)], rank),
        _groups(world, lambda r: [at(x, y, coords(r)[2]) for x in range(d)
                                  for y in range(s)], rank),
    ]
    return Mesh(d, s, t, *coords(rank), *groups)
