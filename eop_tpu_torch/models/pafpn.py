"""Necks (counterpart of ``eop_tpu/models/pafpn.py``): ``YOLOPAFPN``, the
PAN neck over CSPDarknet (darknet backbone), and ``YOLOFPN``, YOLOv3's FPN
over the classic Darknet."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.blocks import BaseConv, CSPLayer, conv_class
from .darknet import CSPDarknet, Darknet

IN_FEATURES = ("dark3", "dark4", "dark5")


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample (torch ``nn.Upsample(2)``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOPAFPN(nn.Module):
    """Returns ``(pan_out2, pan_out1, pan_out0, x2, x1, x0)``: the FPN maps
    at strides 8/16/32 and the raw backbone taps (the reference's 6-tuple),
    in the compute ``dtype``."""

    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 act: str = "silu", dtype: torch.dtype = torch.float32,
                 depthwise: bool = False):
        super().__init__()
        conv = dict(act=act, dtype=dtype)
        self.backbone = CSPDarknet(depth, width, IN_FEATURES,
                                   depthwise=depthwise, **conv)
        base_ch = int(width * 64)
        b2, b1, b0 = base_ch * 4, base_ch * 8, base_ch * 16  # dark3/4/5
        c0, c1, c2 = [int(c * width) for c in in_channels]
        n = round(3 * depth)
        csp = dict(n=n, shortcut=False, depthwise=depthwise, **conv)
        Conv = conv_class(depthwise)

        self.lateral_conv0 = BaseConv(b0, c1, 1, **conv)
        self.C3_p4 = CSPLayer(c1 + b1, c1, **csp)
        self.reduce_conv1 = BaseConv(c1, c0, 1, **conv)
        self.C3_p3 = CSPLayer(c0 + b2, c0, **csp)
        self.bu_conv2 = Conv(c0, c0, 3, 2, **conv)
        self.C3_n3 = CSPLayer(c0 + c0, c1, **csp)
        self.bu_conv1 = Conv(c1, c1, 3, 2, **conv)
        self.C3_n4 = CSPLayer(c1 + c1, c2, **csp)

    def forward(self, x):
        feats = self.backbone(x)
        x2, x1, x0 = [feats[f] for f in IN_FEATURES]

        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = torch.cat([upsample2x_nearest(fpn_out0), x1], dim=1)
        f_out0 = self.C3_p4(f_out0)

        fpn_out1 = self.reduce_conv1(f_out0)
        f_out1 = torch.cat([upsample2x_nearest(fpn_out1), x2], dim=1)
        pan_out2 = self.C3_p3(f_out1)

        p_out1 = torch.cat([self.bu_conv2(pan_out2), fpn_out1], dim=1)
        pan_out1 = self.C3_n3(p_out1)

        p_out0 = torch.cat([self.bu_conv1(pan_out1), fpn_out0], dim=1)
        pan_out0 = self.C3_n4(p_out0)
        return (pan_out2, pan_out1, pan_out0, x2, x1, x0)


def _embedding(filters: Sequence[int], in_filters: int, dtype: torch.dtype):
    """Five lrelu convs 1x1 / 3x3 / 1x1 / 3x3 / 1x1 (the reference's
    ``_make_embedding``)."""
    f0, f1 = filters
    conv = dict(act="lrelu", dtype=dtype)
    return nn.Sequential(
        BaseConv(in_filters, f0, 1, **conv), BaseConv(f0, f1, 3, **conv),
        BaseConv(f1, f0, 1, **conv), BaseConv(f0, f1, 3, **conv),
        BaseConv(f1, f0, 1, **conv))


class YOLOFPN(nn.Module):
    """YOLOv3's FPN over ``Darknet(depth)`` (reference ``YOLOFPN``): returns
    ``(out_dark3, out_dark4, x0)`` with 128, 256 and 512 channels."""

    def __init__(self, depth: int = 53, dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = dict(act="lrelu", dtype=dtype)
        self.backbone = Darknet(depth, out_features=IN_FEATURES, dtype=dtype)
        self.out1_cbl = BaseConv(512, 256, 1, **conv)
        self.out1 = _embedding((256, 512), 512 + 256, dtype)
        self.out2_cbl = BaseConv(256, 128, 1, **conv)
        self.out2 = _embedding((128, 256), 256 + 128, dtype)

    def forward(self, x):
        feats = self.backbone(x)
        x2, x1, x0 = [feats[f] for f in IN_FEATURES]
        x1_in = torch.cat([upsample2x_nearest(self.out1_cbl(x0)), x1], dim=1)
        out_dark4 = self.out1(x1_in)
        x2_in = torch.cat([upsample2x_nearest(self.out2_cbl(out_dark4)), x2],
                          dim=1)
        out_dark3 = self.out2(x2_in)
        return (out_dark3, out_dark4, x0)
