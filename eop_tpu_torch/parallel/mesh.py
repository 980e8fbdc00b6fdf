"""Data parallelism over processes (counterpart of the data-axis parts of
``eop_tpu/parallel/mesh.py``).

``eop_tpu`` jits one program over a device mesh and GSPMD makes every
reduction global.  The port runs one process per GPU and makes the same
reductions global by hand, so that its step is, as ``eop_tpu``'s sharded
step is, the single-device step on the global batch:

* :func:`shard_batch` gives a rank its rows of a global batch, in the
  micro-batch layout of ``eop_tpu``'s ``_accum_scan`` when ``accum > 1``;
* the BatchNorm statistics are global (``parallel/global_bn.py``), and so
  are the losses' normalisers and DWA inputs (``losses`` with a group);
* :func:`shard_train_step` averages the gradients over the ranks (one
  ``all_reduce`` before the optimizer step), or, under ``fsdp``, leaves it
  to ``fully_shard``'s reduce-scatter;
* :func:`place_state` shards the model, the momentum and the EMA over the
  ranks (``fsdp``); :func:`state_to_host` gathers them back on every rank;
* :func:`shard_inference` runs each rank's share of a batch and gathers
  the rows.

``make_mesh``, ``image_spec``, ``param_specs`` and the sharding
constraints have no counterpart: the process group is the mesh, a rank
holds its rows, and ``fully_shard`` decides the parameter layout.  The
spatial and tensor axes (``--spatial``, ``--tensor``,
``shard_inference_tp``) are not ported (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..utils.logger import logger
from .dist import get_rank, get_world_size

__all__ = [
    "average_gradients",
    "place_state",
    "shard_batch",
    "shard_inference",
    "shard_train_step",
    "state_bytes",
    "state_to_host",
    "sync_batch_stats",
]


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every tensor or array leaf of nested dicts, lists, tuples
    and named tuples; other leaves as they are."""
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if hasattr(tree, "shape"):
        return fn(tree)
    return tree


def shard_batch(batch, rank: int, world: int, accum: int = 1):
    """Rank ``rank``'s rows of a global batch (tensors or arrays with the
    batch first, alone or in dicts / tuples): ``eop_tpu``'s data-axis
    sharding of each micro-batch.  The global batch ``[B]`` splits into
    ``accum`` micro-batches of ``B / accum`` rows (``_accum_scan``'s
    ``[accum, B / accum]`` reshape), each sharded over the ranks, so a rank
    holds ``B / world`` rows: its share of micro-batch 0, then of 1, ...,
    which the step's ``chunk(accum)`` takes apart again."""

    def rows(x):
        b = x.shape[0]
        if b % (accum * world):
            raise ValueError(f"batch {b} does not split into accum={accum} "
                             f"x world={world}")
        per = b // (accum * world)
        return x.reshape(accum, world, per, *x.shape[1:])[:, rank].reshape(
            accum * per, *x.shape[1:])

    return _tree_map(rows, batch)


def _grads(params) -> list:
    return [p.grad for p in params if p.grad is not None]


def average_gradients(params, group) -> None:
    """Replace each gradient by its mean over ``group``'s ranks, in one
    ``all_reduce`` of the flattened gradients (a bucket per dtype)."""
    world = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for g in _grads(params):
        by_dtype.setdefault(g.dtype, []).append(g)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for g, avg in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(avg)


def shard_train_step(step_fn: Callable, group=None,
                     fsdp: bool = False) -> Callable:
    """``step(state, images, labels)`` of ``make_train_step_*`` (made with
    the same ``group``) run data-parallel over ``group``: after the
    micro-batches' backward and before the optimizer step, the gradients
    are averaged over the ranks, which, with every rank's loss scaled by
    the world size, is the global batch's gradient.  Under ``fsdp`` (the
    model given to :func:`place_state`) ``fully_shard``'s reduce-scatter
    averages them in the backward and nothing is added.  Without a group
    the step is ``step_fn``."""
    if group is None or fsdp:
        return step_fn

    def step(state, images, labels):
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        hook = state.optimizer.register_step_pre_hook(
            lambda *_: average_gradients(params, group))
        try:
            return step_fn(state, images, labels)
        finally:
            hook.remove()

    return step


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def state_bytes(state) -> Tuple[int, int]:
    """(bytes this rank holds, bytes of the whole state) over the model's
    parameters and buffers, the momentum, the EMA and the DWA state."""
    tensors = [*state.model.parameters(), *state.model.buffers()]
    tensors += [s["momentum_buffer"] for s in state.optimizer.state.values()
                if s.get("momentum_buffer") is not None]
    for d in (state.ema_params, state.ema_batch_stats):
        tensors += list((d or {}).values())
    if state.dwa is not None:
        tensors += list(state.dwa)
    local = sum(_local(t).numel() * t.element_size() for t in tensors)
    total = sum(t.numel() * t.element_size() for t in tensors)
    return local, total


def place_state(state, fsdp: bool = False, group=None):
    """Place a ``TrainState`` for data parallelism over ``group``, in
    place, once before the first step.  ``fsdp`` (ZeRO-style, as
    ``eop_tpu``'s ``--fsdp``): ``fully_shard`` of the model over the
    group's ranks (parameters as ``DTensor`` shards, gathered for each
    forward and backward, gradients reduce-scattered); the momentum and the
    EMA parameters and statistics are sharded like the parameters.
    Otherwise everything stays replicated.  Logs the share of the state's
    bytes held off this rank, and warns where ``fsdp`` shards nothing (no
    group, or one rank)."""
    world = get_world_size(group) if group is not None else 1
    if fsdp and group is not None:
        _fully_shard(state, group)
    local, total = state_bytes(state)
    off = 1.0 - local / total if total else 0.0
    msg = (f"place_state: {off:.1%} of state bytes sharded off the rank "
           f"({local} of {total} bytes on each rank; world {world}, "
           f"fsdp={fsdp})")
    if fsdp and off == 0.0:
        logger.warning(msg + ": fsdp shards nothing without a group of "
                       "more than one rank; the state stays replicated")
    else:
        logger.info(msg)
    return state


def _fully_shard(state, group) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard, distribute_tensor

    model, opt = state.model, state.optimizer
    device = next(model.parameters()).device
    mesh = DeviceMesh.from_group(group, device.type)
    with torch.no_grad():
        # fully_shard takes contiguous parameters only (not channels_last
        # conv kernels); the gathered ones it hands the forward are too
        for p in model.parameters():
            p.data = p.data.contiguous()
    before = list(model.parameters())
    fully_shard(model, mesh=mesh)
    after = dict(zip(map(id, before), model.parameters()))

    def shard(t):
        # every rank holds the same full tensor: each keeps its own chunk
        return distribute_tensor(t.detach(), mesh, [Shard(0)],
                                 src_data_rank=None)

    for g in opt.param_groups:
        g["params"] = [after[id(p)] for p in g["params"]]
    moved = defaultdict(dict)
    for p, s in opt.state.items():
        moved[after[id(p)]] = {k: shard(v) if k == "momentum_buffer" else v
                               for k, v in s.items()}
    opt.state = moved
    for field in ("ema_params", "ema_batch_stats"):
        d = getattr(state, field)
        if d is not None:
            setattr(state, field, {k: shard(v) for k, v in d.items()})


def state_to_host(tree):
    """``tree`` with every sharded tensor (``DTensor``) gathered whole, on
    every rank: a collective under ``fsdp``, which every rank joins (before
    a rank-0-only write or an evaluation); other tensors as they are."""
    return _tree_map(
        lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, tree)


@torch.no_grad()
def sync_batch_stats(model: nn.Module, group=None) -> nn.Module:
    """Average the floating buffers (BatchNorm running mean and variance)
    over ``group``'s ranks, in place (the reference's ``all_reduce_norm``:
    the variances are averaged, not pooled).  Returns ``model``."""
    world = get_world_size(group)
    if world == 1:
        return model
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    flat = _flatten_dense_tensors(bufs)
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    for b, avg in zip(bufs, _unflatten_dense_tensors(flat, bufs)):
        b.copy_(avg)
    return model


def shard_inference(infer_fn: Callable, group=None) -> Callable:
    """A batched ``infer_fn`` (a batch -> a tensor or a named tuple of
    tensors with the batch first) run data-parallel: each rank computes
    its ``B / world`` contiguous rows, and the rows come back gathered in
    order on every rank (one ``all_gather`` per output)."""

    def run(imgs):
        world, rank = get_world_size(group), get_rank(group)
        if world == 1:
            return infer_fn(imgs)
        b = imgs.shape[0]
        if b % world:
            raise ValueError(f"batch {b} does not split over {world} ranks")
        per = b // world
        out = infer_fn(imgs[rank * per:(rank + 1) * per])

        def gathered(t):
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts)

        return _tree_map(gathered, out)

    return run
