"""Model summary and deploy-time fusion (counterpart of
``eop_tpu/utils/model_utils.py``): ``get_model_info``, the parameter count
and the multiply-accumulates of one forward at batch 1, counted as
``eop_tpu`` counts them; ``fuse_conv_bn``,
each BatchNorm that follows a conv folded into that conv's weights."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def count_params(model: nn.Module) -> int:
    """Trainable parameters (BatchNorm statistics are buffers, as they are
    ``batch_stats`` in the JAX package, not ``params``)."""
    return sum(p.numel() for p in model.parameters())


def inside_taps(n: int, k: int, stride: int, padding: int) -> int:
    """The (output, kernel tap) pairs along one axis of ``n`` inputs whose
    tap lands inside the input, not on the padding."""
    n_out = (n + 2 * padding - k) // stride + 1
    total = 0
    for t in range(k):
        lo = max(0, -((t - padding) // stride))  # ceil((padding - t) / s)
        hi = min(n_out - 1, (n - 1 + padding - t) // stride)
        total += max(0, hi - lo + 1)
    return total


def conv_macs(batch: int, hw, c_in: int, co: int, k: int, stride: int,
              padding: int) -> int:
    """Multiply-accumulates of a square conv (``c_in`` input channels a
    group) as XLA's cost analysis counts a convolution: each output's
    taps that land inside the input, none of those on the padding."""
    return (batch * co * c_in * inside_taps(hw[0], k, stride, padding)
            * inside_taps(hw[1], k, stride, padding))


class _ConvCounter(torch.overrides.TorchFunctionMode):
    """Sums :func:`conv_macs` over the ``F.conv2d`` calls it sees, with
    the arguments they were given (``FlopCounterMode`` counts every tap,
    those on the padding too)."""

    def __init__(self):
        super().__init__()
        self.macs = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is F.conv2d:
            x, w = args[0], args[1]
            arg = dict(zip(("bias", "stride", "padding", "dilation",
                            "groups"), args[2:]), **kwargs)
            stride, padding = (_pair(arg.get("stride", 1)),
                               _pair(arg.get("padding", 0)))
            if (_pair(arg.get("dilation", 1)) == (1, 1)
                    and len(set(stride)) == 1 and len(set(padding)) == 1
                    and w.shape[2] == w.shape[3]):
                self.macs += conv_macs(x.shape[0], x.shape[2:], w.shape[1],
                                       w.shape[0], w.shape[2], stride[0],
                                       padding[0])
            else:  # no model has one: every tap of every output
                self.macs += out.numel() * w[0].numel()
        return out


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def count_macs(model: nn.Module, tsize: Tuple[int, int]) -> int:
    """Multiply-accumulates of one eval-mode forward of a ``[1, 3,
    *tsize]`` image, counted on the meta device: the parameters and
    buffers as meta tensors (``functional_call``), so nothing runs on the
    model's device, no kernel launches and the count is the same on the
    card and on the CPU.  Every conv counts as the conv it computes, as
    XLA's cost analysis counts a convolution (:func:`conv_macs`); on a
    meta tensor ``phase_conv`` computes its conv with ``F.conv2d``, so its
    convs count as the others do."""
    from torch.func import functional_call

    meta = {name: torch.empty_like(t, device="meta") for name, t in (
        *model.named_parameters(), *model.named_buffers())}
    x = torch.zeros((1, 3, *tsize), device="meta").contiguous(
        memory_format=torch.channels_last)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), _ConvCounter() as counter:
            functional_call(model, meta, (x,))
    finally:
        model.train(was_training)
    return counter.macs


def get_model_info(model: nn.Module, tsize: Tuple[int, int]) -> str:
    """``"Params: {:.2f}M, Gflops: {:.2f}"`` (the reference's summary): the
    parameters and :func:`count_macs` (multiply-accumulates, as thop counts
    and ``eop_tpu`` reports: XLA's cost analysis, halved).  XLA's figure
    also holds the elementwise work (each BaseConv's BatchNorm and SiLU,
    8 flops an element in XLA's count, and the adds, pools and the head's
    decode: 7.5-8.2 flops an output element of a BaseConv at the test
    sizes), which this count leaves out: it lies about 2 % under
    ``eop_tpu``'s for YOLOX (tests/test_torch_tooling.py)."""
    return "Params: {:.2f}M, Gflops: {:.2f}".format(
        count_params(model) / 1e6, count_macs(model, tsize) / 1e9)


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
