"""Top-level YOLOX model (counterpart of ``eop_tpu/models/yolox.py``).

``forward`` returns ``(head_outs, fpn_outs)``: the raw per-scale head maps
and the neck's 6-tuple.  Decode (:func:`inference_outputs`,
:func:`training_outputs`) and postprocess are functions applied by the
caller.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .head import (
    PRIOR_BIAS,
    YOLOXHead,
    decode_outputs,
    flatten_head_outputs,
    make_grids_and_strides,
)
from .pafpn import YOLOPAFPN


class YOLOX(nn.Module):
    """YOLOPAFPN(CSPDarknet) -> YOLOXHead, attribute names ``backbone`` and
    ``head`` as in the reference."""

    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 num_classes: int = 80, reg_dim: int = 4,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 act: str = "silu"):
        super().__init__()
        self.backbone = YOLOPAFPN(depth, width, in_channels, act)
        self.head = YOLOXHead(num_classes, width, in_channels, reg_dim, act)

    def forward(self, x):
        fpn_outs = self.backbone(x)
        return self.head(fpn_outs[:3]), fpn_outs


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
    sigmoided obj/cls."""
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
    grids ``[A, 2]``, strides ``[A]``): what the training loss consumes."""
    flat = flatten_head_outputs(head_outs)
    grids, strides_flat = make_grids_and_strides(
        [tuple(o.shape[2:4]) for o in head_outs], strides, flat.device,
        flat.dtype)
    decoded = decode_outputs(flat, grids, strides_flat, reg_dim,
                             apply_sigmoid=False)
    return decoded, flat[..., :reg_dim], grids, strides_flat
