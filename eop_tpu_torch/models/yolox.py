"""Top-level models (counterpart of ``eop_tpu/models/yolox.py``): ``YOLOX``
and ``YOLOv3``.

``forward`` returns ``(head_outs, fpn_outs)``: the raw per-scale head maps
and the neck's 6-tuple, in the compute ``dtype``.  Decode
(:func:`inference_outputs`, :func:`training_outputs`) and postprocess are
functions applied by the caller.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.blocks import batch_stats_frozen
from .densenet import ChannelDropout
from .head import (
    PRIOR_BIAS,
    YOLOXHead,
    decode_outputs,
    flatten_head_outputs,
    make_grids_and_strides,
)
from .pafpn import YOLOFPN, YOLOPAFPN


def dropouts(model: nn.Module):
    """The distinct :class:`ChannelDropout` generators of ``model``'s
    modules (DenseNet's)."""
    found = {}
    for m in model.modules():
        d = getattr(m, "dropout", None)
        if isinstance(d, ChannelDropout):
            found[id(d)] = d
    return list(found.values())


def _remat_contexts(module: nn.Module):
    """The checkpoint's (forward, recompute) contexts.  The recompute
    leaves the BatchNorm running statistics alone and draws the forward's
    dropout masks again: it starts each generator from the state the
    forward started from, and leaves it where the forward left it."""
    gens = dropouts(module)
    at_start = []

    @contextlib.contextmanager
    def forward():
        at_start[:] = [d.get_state() for d in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        after = [d.get_state() for d in gens]
        for d, state in zip(gens, at_start):
            d.set_state(state)
        try:
            with batch_stats_frozen():
                yield
        finally:
            for d, state in zip(gens, after):
                d.set_state(state)

    return forward(), recompute()


class YOLOX(nn.Module):
    """YOLOPAFPN(backbone) -> YOLOXHead, attribute names ``backbone`` and
    ``head`` as in the reference; ``backbone_type`` one of
    ``pafpn.BACKBONE_TYPES``.

    ``dtype`` is the compute dtype of every conv (``ops/blocks.py``).
    ``depthwise`` makes the 3x3 convs of backbone, neck and head ``DWConv``s
    (YOLOX-Nano).  ``remat`` checkpoints the backbone + neck, not the head
    (JAX: ``nn.remat(YOLOPAFPN)``): in train mode under autograd their
    activations are not kept but recomputed in the backward, which launches
    the early convs' forward kernel a second time; the recompute leaves
    BatchNorm's running statistics alone, so a step updates them once, as
    JAX's functional remat does, and draws DenseNet's dropout masks again
    from the generator state the forward started from.
    """

    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 num_classes: int = 80, reg_dim: int = 4,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 act: str = "silu", dtype: torch.dtype = torch.float32,
                 remat: bool = False, depthwise: bool = False,
                 backbone_type: str = "darknet"):
        super().__init__()
        self.backbone = YOLOPAFPN(depth, width, in_channels, act, dtype,
                                  depthwise, backbone_type)
        self.head = YOLOXHead(num_classes, width, in_channels, reg_dim, act,
                              dtype, depthwise)
        self.remat = remat

    def forward(self, x):
        if self.remat and self.training and torch.is_grad_enabled():
            fpn_outs = checkpoint(
                self.backbone, x, use_reentrant=False,
                context_fn=lambda: _remat_contexts(self.backbone))
        else:
            fpn_outs = self.backbone(x)
        return self.head(fpn_outs[:3]), fpn_outs


class YOLOv3(nn.Module):
    """YOLOFPN(Darknet) -> the box head with lrelu over its 128 / 256 / 512
    channels (``eop_tpu``'s ``YOLOv3``, the ``yolov3`` exp's model).
    ``forward`` returns ``(head_outs, fpn_outs)`` as :class:`YOLOX` does,
    ``fpn_outs`` the neck's 3-tuple."""

    IN_CHANNELS = (128, 256, 512)

    def __init__(self, num_classes: int = 80, width: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = YOLOFPN(53, dtype)
        self.head = YOLOXHead(num_classes, width, self.IN_CHANNELS, 4,
                              "lrelu", dtype)

    def forward(self, x):
        fpn_outs = self.backbone(x)
        return self.head(fpn_outs), fpn_outs


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random initialisation from a ``torch.Generator``: LeCun-normal
    conv kernels (flax's default family), zero conv biases, identity BN, and
    the head's prior-probability bias on the obj/cls predictions."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=g) / fan_in ** 0.5
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in model.modules():
            if isinstance(m, YOLOXHead):
                for p in list(m.cls_preds) + list(m.obj_preds):
                    p.bias.fill_(PRIOR_BIAS)
    return model


def inference_outputs(head_outs: Sequence[torch.Tensor],
                      strides: Sequence[int] = (8, 16, 32),
                      reg_dim: int = 4) -> torch.Tensor:
    """Raw per-scale maps -> decoded ``[B, A, reg_dim+1+C]`` predictions with
    sigmoided obj/cls, in the maps' dtype (JAX decodes in the head's dtype
    too: bf16 centres near 600 px are 4 px apart)."""
    flat = flatten_head_outputs(head_outs)
    grids, strides_flat = make_grids_and_strides(
        [tuple(o.shape[2:4]) for o in head_outs], strides, flat.device,
        flat.dtype)
    return decode_outputs(flat, grids, strides_flat, reg_dim,
                          apply_sigmoid=True)


def training_outputs(head_outs: Sequence[torch.Tensor],
                     strides: Sequence[int] = (8, 16, 32), reg_dim: int = 4):
    """Raw per-scale maps -> (decoded ``[B, A, C]`` with decoded regression
    and logit obj/cls, raw regression ``[B, A, reg_dim]`` for the L1 loss,
    grids ``[A, 2]``, strides ``[A]``): what the training loss consumes, all
    in the maps' dtype; the loss upcasts."""
    flat = flatten_head_outputs(head_outs)
    grids, strides_flat = make_grids_and_strides(
        [tuple(o.shape[2:4]) for o in head_outs], strides, flat.device,
        flat.dtype)
    decoded = decode_outputs(flat, grids, strides_flat, reg_dim,
                             apply_sigmoid=False)
    return decoded, flat[..., :reg_dim], grids, strides_flat
