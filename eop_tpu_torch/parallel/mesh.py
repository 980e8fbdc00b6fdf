"""Parallelism over processes (counterpart of ``eop_tpu/parallel/mesh.py``).

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

The space and model axes (``--spatial``, ``--tensor``; the layout of the
ranks is ``parallel.dist.make_mesh``'s :class:`~.dist.Mesh`): a space rank
holds rows of its data row's images (``shard_batch``, halo exchanges and
the fence in ``parallel/spatial.py``), a model rank a slice of the
qualifying convs' output channels (``parallel/tensor.py``, placed by
``place_state(tensor=)``).  ``shard_train_step`` then sums the gradients
of the sharded region (stem through dark4) over the space ranks, averages
every gradient over the data ranks, and sums the gradients of the vectors
held whole and used sliced over the model ranks; ``shard_inference_tp``
runs a tensor-parallel model.  ``image_spec``, ``param_specs`` and the
sharding constraints have no counterpart: a rank holds its rows and
channels, and ``fully_shard`` decides the data axis's parameter layout.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..utils.logger import logger
from .dist import Mesh, get_rank, get_world_size
from .spatial import region_modules, shard_rows
from .tensor import convert_tensor, reduce_partial, slice_factor

__all__ = [
    "average_gradients",
    "place_state",
    "shard_batch",
    "shard_inference",
    "shard_inference_tp",
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


def shard_batch(batch, rank: int, world: int, accum: int = 1,
                space_rank: int = 0, spatial: int = 1):
    """Rank ``rank``'s rows of a global batch (tensors or arrays with the
    batch first, alone or in dicts / tuples): ``eop_tpu``'s data-axis
    sharding of each micro-batch.  The global batch ``[B]`` splits into
    ``accum`` micro-batches of ``B / accum`` rows (``_accum_scan``'s
    ``[accum, B / accum]`` reshape), each sharded over the ranks, so a rank
    holds ``B / world`` rows: its share of micro-batch 0, then of 1, ...,
    which the step's ``chunk(accum)`` takes apart again.  With ``spatial``
    space ranks, the 4-D leaves (NHWC images) keep space rank
    ``space_rank``'s height rows (``parallel.spatial.row_split``), in every
    micro-batch, as ``constrain_accum`` keeps them height-sharded; the
    labels stay whole."""

    def rows(x):
        b = x.shape[0]
        if b % (accum * world):
            raise ValueError(f"batch {b} does not split into accum={accum} "
                             f"x world={world}")
        per = b // (accum * world)
        x = x.reshape(accum, world, per, *x.shape[1:])[:, rank].reshape(
            accum * per, *x.shape[1:])
        return shard_rows(x, space_rank, spatial) if x.ndim == 4 else x

    return _tree_map(rows, batch)


def _grads(params) -> list:
    return [p.grad for p in params if p.grad is not None]


def average_gradients(params, group, divisor: Optional[int] = None) -> None:
    """Replace each gradient by its sum over ``group``'s ranks divided by
    ``divisor`` (the group's size: the mean), in one ``all_reduce`` of the
    flattened gradients (a bucket per dtype).  DTensor gradients (under
    ``fsdp``) take their local shards."""
    divisor = dist.get_world_size(group) if divisor is None else divisor
    by_dtype: Dict[torch.dtype, list] = {}
    for g in _grads(params):
        g = _local(g)
        by_dtype.setdefault(g.dtype, []).append(g)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat.div_(divisor)
        for g, avg in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(avg)


def data_mesh(group=None) -> Mesh:
    """The :class:`~.dist.Mesh` of data parallelism alone over ``group``."""
    if group is None:
        return Mesh()
    return Mesh(data_size=dist.get_world_size(group),
                data_rank=dist.get_rank(group), data=group, data_space=group)


def reduce_gradients(model: nn.Module, mesh: Mesh,
                     fsdp: bool = False) -> None:
    """The gradients of a step over ``mesh`` made the global batch's, in
    place, after the backward: the sharded region's (stem through dark4,
    ``parallel.spatial.region_modules``) summed over the space ranks and
    every one averaged over the data ranks, in one ``all_reduce`` over
    data x space (the gradients after the fence, the same on every space
    rank, are averaged over it); under ``fsdp`` (the model given to
    :func:`place_state` with a data group) ``fully_shard``'s
    reduce-scatter has averaged over the data ranks, and the local shards
    are reduced over the space ranks alone.  Then the vectors held whole
    and used sliced are summed over the model ranks and their BatchNorm
    statistics gathered (``parallel.tensor.reduce_partial``)."""
    params = [p for p in model.parameters() if p.grad is not None]
    region = set()
    if mesh.space is not None:
        region = {id(p) for m in region_modules(model)
                  for p in m.parameters()}
    inner = [p for p in params if id(p) in region]
    outer = [p for p in params if id(p) not in region]
    if fsdp and mesh.data is not None:
        group, data = mesh.space, 1
    else:
        group, data = mesh.data_space, mesh.data_size
    if group is not None:
        average_gradients(inner, group, data)
        average_gradients(outer, group, data * mesh.spatial)
    reduce_partial(model)


def shard_train_step(step_fn: Callable, group=None, fsdp: bool = False,
                     mesh: Optional[Mesh] = None) -> Callable:
    """``step(state, images, labels)`` of ``make_train_step_*`` (made with
    the same ``group``: the data group) run in parallel over ``group``, or
    over ``mesh``'s axes: after the micro-batches' backward and before the
    optimizer step, :func:`reduce_gradients`, which, with every rank's
    loss scaled by the data group's size, gives the global batch's
    gradient.  Under ``fsdp`` (the model given to :func:`place_state`)
    ``fully_shard``'s reduce-scatter averages over the data ranks in the
    backward.  Without any group the step is ``step_fn``."""
    mesh = mesh if mesh is not None else data_mesh(group)
    by_fsdp = fsdp and mesh.data is not None
    if (mesh.data_space is None or by_fsdp) and mesh.space is None and (
            mesh.model is None):
        return step_fn

    def step(state, images, labels):
        hook = state.optimizer.register_step_pre_hook(
            lambda *_: reduce_gradients(state.model, mesh, fsdp))
        try:
            return step_fn(state, images, labels)
        finally:
            hook.remove()

    return step


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def state_bytes(state) -> Tuple[int, int]:
    """(bytes this rank holds, bytes of the whole state) over the model's
    parameters and buffers, the momentum, the EMA and the DWA state; a
    tensor-parallel slice counts whole in the second."""
    model = state.model
    named = [*model.named_parameters(), *model.named_buffers()]
    names = {id(p): n for n, p in model.named_parameters()}
    named += [(names.get(id(p)), s["momentum_buffer"])
              for p, s in state.optimizer.state.items()
              if s.get("momentum_buffer") is not None]
    for d in (state.ema_params, state.ema_batch_stats):
        named += list((d or {}).items())
    if state.dwa is not None:
        named += [(None, t) for t in state.dwa]
    local = sum(_local(t).numel() * t.element_size() for _, t in named)
    total = sum(t.numel() * t.element_size() * slice_factor(model, n)
                for n, t in named)
    return local, total


def _take_slices(state, record) -> None:
    """The momentum and the EMA of the tensors :func:`convert_tensor`
    sliced cut to this rank's slice, as the tensors themselves."""
    rank = dist.get_rank(record.group)

    def cut(name, t):
        whole = record.shards[name]
        if tuple(t.shape) != tuple(whole):
            return t
        n = whole[0] // record.size
        return t[rank * n:(rank + 1) * n].clone()

    for field in ("ema_params", "ema_batch_stats"):
        d = getattr(state, field)
        if d is not None:
            setattr(state, field, {k: cut(k, v) if k in record.shards else v
                                   for k, v in d.items()})
    for name, p in state.model.named_parameters():
        s = state.optimizer.state.get(p, {})
        if name in record.shards and s.get("momentum_buffer") is not None:
            s["momentum_buffer"] = cut(name, s["momentum_buffer"])


def place_state(state, fsdp: bool = False, group=None, tensor=None):
    """Place a ``TrainState`` for parallelism, in place, once before the
    first step (after any checkpoint is loaded into it).  ``tensor`` (a
    model group): the qualifying convs compute this rank's slice of their
    output channels, and the leaves ``eop_tpu``'s ``_leaf_spec`` shards
    over the model axis, with their momentum and EMA, keep only this
    rank's slice (``parallel.tensor.convert_tensor``).  ``fsdp``
    (ZeRO-style, as ``eop_tpu``'s ``--fsdp``): ``fully_shard`` of the model
    over ``group``'s ranks, the data group (parameters as ``DTensor``
    shards, gathered for each forward and backward, gradients
    reduce-scattered); the momentum and the EMA parameters and statistics
    are sharded like the parameters; a channel slice is sharded further,
    as any other leaf.  Otherwise everything stays replicated.  Logs the
    share of the state's bytes held off this rank, and warns where
    ``fsdp`` shards nothing (no group, or one rank)."""
    world = get_world_size(group) if group is not None else 1
    if tensor is not None:
        _take_slices(state, convert_tensor(state.model, tensor))
    if fsdp and group is not None:
        _fully_shard(state, group)
    local, total = state_bytes(state)
    off = 1.0 - local / total if total else 0.0
    tp = get_world_size(tensor) if tensor is not None else 1
    msg = (f"place_state: {off:.1%} of state bytes sharded off the rank "
           f"({local} of {total} bytes on each rank; world {world}, "
           f"fsdp={fsdp}, tensor {tp})")
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


def shard_inference(infer_fn: Callable, group=None,
                    space=None) -> Callable:
    """A batched ``infer_fn`` (an NHWC batch -> a tensor or a named tuple
    of tensors with the batch first) run data-parallel over ``group``
    (``None``: this process computes the whole batch): each rank computes
    its ``B / world`` contiguous rows, and the rows come back gathered in
    order on every rank (one ``all_gather`` per output).  With a ``space``
    group each rank passes its height rows of those images
    (``parallel.spatial.row_split``) to ``infer_fn``, whose model must be
    under that group (``parallel.spatial.convert_spatial``): its outputs
    are whole after the fence, the same on every space rank."""

    def run(imgs):
        world, rank = ((get_world_size(group), get_rank(group))
                       if group is not None else (1, 0))
        b = imgs.shape[0]
        if b % world:
            raise ValueError(f"batch {b} does not split over {world} ranks")
        per = b // world
        local = imgs[rank * per:(rank + 1) * per]
        if space is not None:
            local = shard_rows(local, get_rank(space), get_world_size(space))
        out = infer_fn(local)
        if world == 1:
            return out

        def gathered(t):
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts)

        return _tree_map(gathered, out)

    return run


def shard_inference_tp(infer_fn: Callable, model: nn.Module,
                       mesh: Mesh) -> Callable:
    """Tensor-parallel inference (``eop_tpu``'s ``shard_inference_tp``):
    ``model`` (the one ``infer_fn`` runs) keeps this rank's channel slices
    over ``mesh.model`` (``parallel.tensor.convert_tensor``, in place; the
    per-rank weight memory drops by the model group's size), and under
    ``mesh.space`` its rows; the batch is then split over ``mesh.data`` as
    :func:`shard_inference` splits it.  Every rank of the mesh calls the
    returned function with the same batch."""
    from .spatial import convert_spatial

    if mesh.model is not None:
        convert_tensor(model, mesh.model)
    if mesh.space is not None:
        convert_spatial(model, mesh.space)
    return shard_inference(infer_fn, mesh.data, mesh.space)
