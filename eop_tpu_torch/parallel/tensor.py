"""Tensor parallelism: convs computing a slice of their output channels
over the ranks of a model group (counterpart of the model axis of
``eop_tpu/parallel/mesh.py``: ``_leaf_spec`` / ``param_specs``, and the
channel collectives GSPMD inserts around a channel-sharded kernel).

A conv whose kernel ``_leaf_spec`` shards (C_out divisible by the group's
size and at least 256 elements in the kernel as ``eop_tpu`` holds it,
HWIO) computes only this rank's C_out slice: the ``BaseConv``s and the
head's ``cls_preds`` / ``reg_preds``.  Its input gradient is summed over
the model group (:func:`to_model`); its BatchNorm and activation run on the
slice; the channels are then gathered (:func:`gather_channels`, whose
backward keeps this rank's channels).  A ``phase_conv`` conv whose slice
would not be a multiple of 8 channels stays whole: the kernel would take
its CUDA-core ``direct`` variant (``ops/phase_conv.py::kernel_variant``).

Leaves ``_leaf_spec`` shards are held as this rank's slice (the kernel,
and the BatchNorm's four vectors where they have 256 channels or more);
the others are held whole and the conv uses their slice.  The gradient of
such a whole vector is non-zero on this rank's slice only and is summed
over the model group, the gradients of the parameters held whole are
averaged there, and the running statistics a slice updates are gathered
after the step (:func:`reduce_partial`), all by
``parallel.mesh.shard_train_step``.  :func:`whole_tensors` gathers the
slices back by name (checkpoints, evaluation).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

__all__ = [
    "LEAF_MIN_SIZE",
    "TensorParallel",
    "TensorSlice",
    "convert_tensor",
    "gather_channels",
    "kept_whole",
    "reduce_partial",
    "slice_factor",
    "to_model",
    "whole_tensors",
]

# eop_tpu's _leaf_spec leaves smaller leaves replicated
LEAF_MIN_SIZE = 256
# a phase_conv slice narrower than a multiple of this takes `direct`
KERNEL_CHANNELS = 8


class TensorSlice(NamedTuple):
    """A conv's share of its output channels: ``[lo, hi)`` on this rank of
    the ``size`` ranks of ``group``; ``whole_vectors`` where its
    BatchNorm's vectors (a prediction conv's bias) are held whole and
    used sliced."""

    group: object
    size: int
    lo: int
    hi: int
    whole_vectors: bool


class TensorParallel(NamedTuple):
    """What :func:`convert_tensor` did to a model: the model group, its
    size, the state_dict names held as slices (name -> whole shape), the
    parameters held whole whose gradients are partial, and the BatchNorm
    modules held whole and run on a slice."""

    group: object
    size: int
    shards: Dict[str, torch.Size]
    partial: List[str]
    sliced_bns: List[nn.Module]


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous(memory_format=torch.channels_last)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over the model ``group`` (each rank's
    slice of a conv gives its share of the input gradient)."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _ToModel.apply(x, group)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, tp):
        yh = y.permute(0, 2, 3, 1).contiguous()
        parts = [torch.empty_like(yh) for _ in range(tp.size)]
        dist.all_gather(parts, yh, group=tp.group)
        ctx.slice = (tp.lo, tp.hi)
        return torch.cat(parts, 3).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.slice
        return g.permute(0, 2, 3, 1)[..., lo:hi].contiguous().permute(
            0, 3, 1, 2), None


def gather_channels(y: torch.Tensor, tp: TensorSlice) -> torch.Tensor:
    """NCHW ``y``, this rank's channel slice, gathered whole on every rank
    of the model group (channels_last memory); the backward keeps this
    rank's channels."""
    return _GatherChannels.apply(y, tp)


def _leaf_sharded(shape, size: int) -> bool:
    """``eop_tpu``'s ``_leaf_spec`` on the model axis: the trailing
    (output-channel) dim of the leaf as ``eop_tpu`` holds it divides, and
    the leaf has at least :data:`LEAF_MIN_SIZE` elements."""
    n = 1
    for v in shape:
        n *= int(v)
    return n >= LEAF_MIN_SIZE and int(shape[-1]) % size == 0


def _hwio(w: torch.Tensor):
    """An OIHW kernel's shape as ``eop_tpu`` holds it (HWIO)."""
    co, ci, kh, kw = w.shape
    return (kh, kw, ci, co)


def kept_whole(model: nn.Module, size: int) -> List[str]:
    """The ``phase_conv`` convs whose kernel ``_leaf_spec`` shards over
    ``size`` ranks but whose slice is no multiple of 8 channels: they stay
    whole (their slice would take the ``direct`` kernel)."""
    from ..ops.blocks import BaseConv

    return [name for name, m in model.named_modules()
            if isinstance(m, BaseConv) and m.phase_conv
            and _leaf_sharded(_hwio(m.conv.weight), size)
            and _conv_plan(m, size) is None]


def _conv_plan(m, size: int) -> Optional[bool]:
    """Whether a ``BaseConv`` or prediction conv computes a slice: None
    where it stays whole, else whether its vectors are held whole."""
    from ..ops.blocks import BaseConv

    if isinstance(m, BaseConv):
        w, co = m.conv.weight, m.conv.out_channels
        if m.conv.groups not in (1, co) or not _leaf_sharded(_hwio(w), size):
            return None
        if m.phase_conv and (co // size) % KERNEL_CHANNELS:
            return None
        return not _leaf_sharded((co,), size)
    if not _leaf_sharded(_hwio(m.weight), size):
        return None
    return m.bias is not None and not _leaf_sharded(m.bias.shape, size)


def _prediction_convs(model: nn.Module):
    from ..models.head import YOLOXHead

    for m in model.modules():
        if isinstance(m, YOLOXHead):
            yield from m.cls_preds
            yield from m.reg_preds
            yield from m.obj_preds


def convert_tensor(model: nn.Module, group) -> TensorParallel:
    """Make ``model``'s qualifying convs compute this rank's slice of their
    output channels over the model ``group``, in place: their kernels
    (and the vectors ``_leaf_spec`` shards) keep only this rank's slice
    (``param.data`` replaced: the parameter objects stay, so an optimizer
    built on them keeps working).  Call before the model's first forward
    under autograd (autograd keeps a parameter's shape from then on),
    before the optimizer's first step and before ``fsdp``.  The study's
    ResNet50 and DenseNet121 backbones raise ``NotImplementedError``.
    Returns the :class:`TensorParallel` record, also kept as
    ``model.tensor_parallel``."""
    from ..models.densenet import DenseNet
    from ..models.resnet import ResNet
    from ..ops.blocks import BaseConv

    if any(isinstance(m, (ResNet, DenseNet)) for m in model.modules()):
        raise NotImplementedError(
            "--tensor: the study's ResNet50 and DenseNet121 backbones are not "
            "ported under tensor sharding (ROADMAP.md queue 1 item 10)")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    names = {id(v): k for k, v in model.named_parameters()}
    names.update({id(v): k for k, v in model.named_buffers()})
    shards, partial, sliced_bns = {}, [], []

    def keep_slice(t, lo, hi):
        shards[names[id(t)]] = t.shape
        t.data = t.data[lo:hi].clone()

    convs = [m for m in model.modules() if isinstance(m, BaseConv)]
    for m in convs + list(_prediction_convs(model)):
        whole = _conv_plan(m, size)
        if whole is None:
            continue
        conv = m.conv if isinstance(m, BaseConv) else m
        co = conv.out_channels
        lo, hi = rank * co // size, (rank + 1) * co // size
        keep_slice(conv.weight, lo, hi)
        vectors = ([m.bn.weight, m.bn.bias, m.bn.running_mean,
                    m.bn.running_var] if isinstance(m, BaseConv)
                   else [conv.bias] if conv.bias is not None else [])
        if whole:
            partial += [names[id(v)] for v in vectors
                        if isinstance(v, nn.Parameter)]
            if isinstance(m, BaseConv):
                m.bn.channels = (lo, hi)
                sliced_bns.append(m.bn)
        else:
            for v in vectors:
                keep_slice(v, lo, hi)
        m.tp = TensorSlice(group, size, lo, hi, whole)
    record = TensorParallel(group, size, shards, partial, sliced_bns)
    model.tensor_parallel = record
    return record


def _gather_dim0(tensors: List[torch.Tensor], group, size: int):
    """Each of ``tensors`` (this rank's dim-0 slices) gathered whole, in
    one ``all_gather`` of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(torch.cat([p[at:at + n].reshape(t.shape) for p in parts]))
        at += n
    return out


def whole_tensors(named: Dict[str, torch.Tensor],
                  model: nn.Module) -> Dict[str, torch.Tensor]:
    """``named`` (state_dict names -> tensors, as the model's state_dict
    or the EMA hold them) with each slice of a tensor-parallel ``model``
    gathered whole over its model group (a collective: every rank of the
    group joins); as it is without one."""
    tp = getattr(model, "tensor_parallel", None)
    if tp is None or not named:
        return named
    keys = [k for k in named if k in tp.shards]
    if not keys:
        return named
    wholes = _gather_dim0([named[k].detach() for k in keys], tp.group, tp.size)
    return {**named, **dict(zip(keys, wholes))}


def slice_factor(model: nn.Module, name: str) -> int:
    """How many ranks hold a slice of ``model``'s tensor ``name`` (1 where
    it is held whole)."""
    tp = getattr(model, "tensor_parallel", None)
    return tp.size if tp is not None and name in tp.shards else 1


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _all_reduce(grads: List[torch.Tensor], group, divisor: int) -> None:
    """Each of ``grads`` summed over ``group`` and divided by
    ``divisor``, in place, in one ``all_reduce``."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat.div_(divisor)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].reshape(g.shape))
        at += g.numel()


@torch.no_grad()
def reduce_partial(model: nn.Module) -> None:
    """After the backward, before the optimizer step: sum over the model
    group the gradients of the vectors held whole and used sliced, average
    there the gradients of the parameters every rank holds whole (the same
    up to the order of cuDNN's atomic sums, which would otherwise let the
    ranks' copies drift apart), and gather the running statistics each
    rank's slice of a BatchNorm held whole updated."""
    tp = getattr(model, "tensor_parallel", None)
    if tp is None:
        return
    partial = set(tp.partial)
    by_kind = {True: [], False: []}
    for n, p in model.named_parameters():
        if p.grad is not None and n not in tp.shards:
            by_kind[n in partial].append(_local(p.grad))
    _all_reduce(by_kind[True], tp.group, 1)
    _all_reduce(by_kind[False], tp.group, tp.size)
    if tp.sliced_bns:
        mine = [b for bn in tp.sliced_bns
                for b in (bn.running_mean[bn.channels[0]:bn.channels[1]],
                          bn.running_var[bn.channels[0]:bn.channels[1]])]
        wholes = _gather_dim0(mine, tp.group, tp.size)
        for bn, mean, var in zip(tp.sliced_bns, wholes[0::2], wholes[1::2]):
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
