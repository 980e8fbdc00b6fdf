"""Decoupled YOLOX head + the pure decode functions (counterpart of
``eop_tpu/models/head.py``).

The module computes only the conv trunk: per-scale raw maps with channels
``[reg(reg_dim) | obj(1) | cls(num_classes)]``, undecoded and un-sigmoided.
Maps are NCHW (channels_last memory); :func:`flatten_head_outputs` turns
them into the JAX ``[B, A, C]`` layout, scale-major and row-major within a
scale.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.blocks import BaseConv, conv_class

# obj/cls prediction biases start at -log((1 - p) / p)
PRIOR_PROB = 1e-2
PRIOR_BIAS = -math.log((1.0 - PRIOR_PROB) / PRIOR_PROB)


class YOLOXHead(nn.Module):
    """``reg_dim=4`` is the bbox head, ``reg_dim=26`` the 24-point head
    (center xy + 24 radii).  The maps come out in the compute ``dtype``; the
    1x1 predictions keep fp32 weights and biases and, in another ``dtype``,
    add the cast bias to the cast conv's output as flax's
    ``nn.Conv(dtype=..., param_dtype=float32)`` does.  Where ``depthwise``,
    the 3x3 convs of both branches are ``DWConv``s (the stems stay 1x1)."""

    def __init__(self, num_classes: int = 80, width: float = 1.0,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 reg_dim: int = 4, act: str = "silu",
                 dtype: torch.dtype = torch.float32, depthwise: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.reg_dim = reg_dim
        self.dtype = dtype
        conv = dict(act=act, dtype=dtype)
        hidden = int(256 * width)
        Conv = conv_class(depthwise)
        self.stems = nn.ModuleList()
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        self.obj_preds = nn.ModuleList()
        for c in in_channels:
            self.stems.append(BaseConv(int(c * width), hidden, 1, **conv))
            for convs in (self.cls_convs, self.reg_convs):
                convs.append(nn.Sequential(
                    Conv(hidden, hidden, 3, **conv),
                    Conv(hidden, hidden, 3, **conv)))
            self.cls_preds.append(nn.Conv2d(hidden, num_classes, 1))
            self.reg_preds.append(nn.Conv2d(hidden, reg_dim, 1))
            self.obj_preds.append(nn.Conv2d(hidden, 1, 1))

    def _pred(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return conv(x)
        dt = self.dtype
        return (F.conv2d(x, conv.weight.to(dt))
                + conv.bias.to(dt)[:, None, None])

    def forward(self, xin):
        outputs = []
        for k, x in enumerate(xin):
            x = self.stems[k](x)
            cls_out = self._pred(self.cls_preds[k], self.cls_convs[k](x))
            reg_feat = self.reg_convs[k](x)
            obj_out = self._pred(self.obj_preds[k], reg_feat)
            reg_out = self._pred(self.reg_preds[k], reg_feat)
            outputs.append(torch.cat([reg_out, obj_out, cls_out], dim=1))
        return outputs


def make_grids_and_strides(hw: Sequence[Tuple[int, int]],
                           strides: Sequence[int], device=None,
                           dtype=torch.float32):
    """Anchor grid ``[A, 2]`` (x, y cell indices, row-major per scale) and
    ``strides_flat [A]``, concatenated over scales."""
    grid_list, stride_list = [], []
    for (h, w), s in zip(hw, strides):
        xv, yv = np.meshgrid(np.arange(w), np.arange(h))
        grid = np.stack([xv, yv], axis=-1).reshape(-1, 2)
        grid_list.append(grid)
        stride_list.append(np.full((grid.shape[0],), s))
    grids = torch.as_tensor(np.concatenate(grid_list, 0), dtype=dtype,
                            device=device)
    strides_flat = torch.as_tensor(np.concatenate(stride_list, 0),
                                   dtype=dtype, device=device)
    return grids, strides_flat


def flatten_head_outputs(outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-scale NCHW maps -> one ``[B, A, C]`` tensor (scale-major,
    row-major within each scale)."""
    flats = [o.permute(0, 2, 3, 1).reshape(o.shape[0], -1, o.shape[1])
             for o in outputs]
    return torch.cat(flats, dim=1)


def decode_outputs(flat: torch.Tensor, grids: torch.Tensor,
                   strides: torch.Tensor, reg_dim: int = 4,
                   apply_sigmoid: bool = True) -> torch.Tensor:
    """``xy = (p + grid) * stride``; sizes/radii ``= exp(p) * stride`` with
    the exp argument clipped to +-30 (keeps exp and exp^2 finite)."""
    s = strides[None, :, None]
    xy = (flat[..., :2] + grids[None]) * s
    sizes = torch.exp(torch.clamp(flat[..., 2:reg_dim], -30.0, 30.0)) * s
    rest = flat[..., reg_dim:]
    if apply_sigmoid:
        rest = torch.sigmoid(rest)
    return torch.cat([xy, sizes, rest], dim=-1)
