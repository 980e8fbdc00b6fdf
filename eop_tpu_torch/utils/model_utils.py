"""Model summary and deploy-time fusion (counterpart of
``eop_tpu/utils/model_utils.py``): ``get_model_info``, the parameter count
and the multiply-accumulates of one forward at batch 1; ``fuse_conv_bn``,
each BatchNorm that follows a conv folded into that conv's weights."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


def count_params(model: nn.Module) -> int:
    """Trainable parameters (BatchNorm statistics are buffers, as they are
    ``batch_stats`` in the JAX package, not ``params``)."""
    return sum(p.numel() for p in model.parameters())


def get_model_info(model: nn.Module, tsize: Tuple[int, int]) -> str:
    """``"Params: {:.2f}M, Gflops: {:.2f}"`` (the reference's summary).
    The FLOPs are ``torch.utils.flop_counter``'s count of one eval-mode
    forward of a zero ``[1, 3, *tsize]`` image on the model's device,
    halved to multiply-accumulates as thop counts and ``eop_tpu`` reports
    (XLA's cost analysis, halved)."""
    from torch.utils.flop_counter import FlopCounterMode

    p = next(model.parameters())
    x = torch.zeros((1, 3, *tsize), device=p.device).contiguous(
        memory_format=torch.channels_last)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x)
    finally:
        model.train(was_training)
    macs = counter.get_total_flops() / 2.0
    return "Params: {:.2f}M, Gflops: {:.2f}".format(
        count_params(model) / 1e6, macs / 1e9)


def fuse_conv_bn(model: nn.Module) -> nn.Module:
    """Fold every :class:`~eop_tpu_torch.ops.blocks.BaseConv`'s BatchNorm
    into its conv, in place (``eop_tpu``'s ``fuse_conv_bn``; the reference's
    ``fuse_model``); returns ``model``.

    ``factor = gamma / sqrt(running_var + eps)`` multiplies the conv's
    output channels; the shift ``beta - running_mean * factor`` stays where
    ``eop_tpu`` puts it, in the BatchNorm, which becomes the identity with
    that bias (weight 1, running mean 0, running variance ``1 - eps``), so
    the block computes ``act(conv_scaled(x) + shift)``.  ``BaseConv``'s
    folded epilogue then reads scale 1 and that shift: nothing folds twice.

    Only a BatchNorm after its conv folds.  ``eop_tpu`` folds any sibling
    ``conv`` / ``bn`` pair, which takes DenseNet's pre-activation
    ``ConvBlock`` (BN, ReLU, then the conv) too and changes what it
    computes; the port leaves those BatchNorms alone.  ResNet's convs have
    no ``conv`` / ``bn`` pairs and fold in neither package."""
    from ..ops.blocks import BaseConv

    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, BaseConv):
                continue
            bn, w = m.bn, m.conv.weight
            factor = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            w.mul_(factor[:, None, None, None])
            bn.bias.copy_(bn.bias + (0.0 - bn.running_mean) * factor)
            bn.weight.fill_(1.0)
            bn.running_mean.zero_()
            bn.running_var.copy_(torch.ones_like(bn.running_var) - bn.eps)
    return model
