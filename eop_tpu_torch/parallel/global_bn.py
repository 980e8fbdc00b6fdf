"""BatchNorm over the global batch of every rank: what GSPMD gives flax's
``nn.BatchNorm`` in ``eop_tpu``'s sharded step (``jit`` over a
batch-sharded mesh reduces the mean and variance over the whole batch;
``eop_tpu/parallel/mesh.py``, the note above ``sync_batch_stats``).  It has
no counterpart file there.

:func:`global_batch_norm` is a plain function on tensors, CPU or CUDA,
under gloo or NCCL: one ``all_reduce`` of the per-channel (Σx, Σx², count)
in the forward and one of (Σdy, Σdy·x̂) in the backward, statistics in
fp32 also for bf16 inputs (float64 for float64 ones), the variance as flax computes it (E[x²] −
E[x]², biased).  The running variance blends that biased variance, as the
port's :class:`~eop_tpu_torch.ops.blocks.BatchNorm2d` does
(``torch.nn.SyncBatchNorm`` blends the unbiased one, and runs on CUDA
tensors only).

The weight and bias gradients a rank gets are its own rows' share; the
input gradient is the global one's rows.  With every rank's loss scaled by
the world size (``losses`` with a group), averaging the gradients over
the ranks gives the global batch's gradient.

:func:`convert_global_bn` turns a model's ``BatchNorm2d`` modules into
:class:`GlobalBatchNorm2d` in place (same parameters, buffers and
state_dict keys); at world size 1 they are ``BatchNorm2d``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

from ..ops.blocks import BatchNorm2d, stats_frozen

__all__ = ["GlobalBatchNorm2d", "convert_global_bn", "global_batch_norm"]


def _all_reduce(t: torch.Tensor, group) -> None:
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(t, group=group)


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _GlobalBatchNormFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        xf = x.to(_stat_dtype(x))
        count = xf.numel() // c
        sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                          xf.new_full((1,), float(count))])
        _all_reduce(sums, group)
        n = sums[2 * c]
        mean = sums[:c] / n
        var = (sums[c:2 * c] / n - mean * mean).clamp_(min=0.0)
        invstd = torch.rsqrt(var + eps)
        scale = invstd * weight.to(xf.dtype)
        y = (xf - _per_channel(mean)) * _per_channel(scale) + _per_channel(
            bias.to(xf.dtype))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        g = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - _per_channel(mean)) * _per_channel(invstd)
        sums = torch.cat([g.sum((0, 2, 3)), (g * xhat).sum((0, 2, 3))])
        dbias, dweight = sums[:c].clone(), sums[c:].clone()
        dx = None
        if ctx.needs_input_grad[0]:
            _all_reduce(sums, ctx.group)
            mean_dy, mean_dy_xhat = sums[:c] / ctx.n, sums[c:] / ctx.n
            dx = ((g - _per_channel(mean_dy)
                   - xhat * _per_channel(mean_dy_xhat))
                  * _per_channel(invstd * weight.to(g.dtype))).to(x.dtype)
        return (dx, dweight.to(weight.dtype), dbias.to(weight.dtype), None,
                None)


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, running_mean=None,
                      running_var=None, momentum: float = 0.1,
                      eps: float = 1e-5, group=None) -> torch.Tensor:
    """Train-mode BatchNorm of ``x`` ``[N, C, H, W]`` with the statistics
    of every rank's ``x`` in ``group`` (``None``: this process's alone).
    Where given, ``running_mean`` and ``running_var`` blend the global mean
    and the biased global variance with ``momentum`` (torch's
    convention), in place.  Returns ``x``'s dtype."""
    y, mean, var = _GlobalBatchNormFn.apply(x, weight, bias, eps, group)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
            running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
    return y


class GlobalBatchNorm2d(BatchNorm2d):
    """:class:`~eop_tpu_torch.ops.blocks.BatchNorm2d` whose train-mode
    statistics are those of the global batch over ``group``'s ranks; eval
    mode, and a group of one rank, are ``BatchNorm2d``'s.  Under
    ``batch_stats_frozen`` (the recompute of a checkpointed forward) the
    buffers are not updated.  With ``channels`` set (tensor parallelism)
    it normalises that slice of its channels."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (not (self.training and self.track_running_stats)
                or self.group is None
                or dist.get_world_size(self.group) == 1):
            return super().forward(x)
        weight, bias, running_mean, running_var = self.vectors()
        if stats_frozen():
            return global_batch_norm(x, weight, bias, eps=self.eps,
                                     group=self.group)
        y = global_batch_norm(x, weight, bias, running_mean, running_var,
                              self.momentum, self.eps, self.group)
        with torch.no_grad():
            self.num_batches_tracked += 1
        return y


def convert_global_bn(model: nn.Module, group,
                      region_group=None) -> nn.Module:
    """Make every ``BatchNorm2d`` of ``model`` a :class:`GlobalBatchNorm2d`
    over ``group``, in place (the same module objects, parameters, buffers
    and state_dict keys).  ``region_group``, where given, is the group of
    the BatchNorms in a space group's sharded region
    (``parallel.spatial.region_modules``: stem through dark4), which hold
    this rank's rows of its images: data x space there, the data group
    after the fence.  No BatchNorm reduces over a model group: per-channel
    statistics do not cross channel slices.  Returns ``model``."""
    region = set()
    if region_group is not None:
        from .spatial import region_modules

        region = {id(m) for r in region_modules(model) for m in r.modules()}
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.__class__ = GlobalBatchNorm2d
            m.group = region_group if id(m) in region else group
    return model
