"""Darknet backbones (counterpart of ``eop_tpu/models/darknet.py``):
``CSPDarknet`` (YOLOX) and the classic ``Darknet`` 21 / 53 (YOLOv3).

Both emit the same named taps (stem, dark2..dark5) as the JAX modules;
attribute names follow the reference.  CSPDarknet: ``dark2.0`` = the
stride-2 conv, ``dark2.1`` = the CSP layer, ``dark5.1`` = SPP, ``dark5.2`` =
the last CSP layer.  Darknet: positional ``nn.Sequential``s, ``stem.0`` the
3x3/s1 conv, ``stem.1`` the stride-2 conv, ``stem.2`` a ``ResLayer``,
``darkN.0`` the stride-2 conv then the ``ResLayer``s, and ``dark5`` ending in
the five entries of the SPP block.

The narrow early convs the TPU ``phase_conv`` kernel was written for run
through the port's Hopper ``phase_conv``.  CSPDarknet: the Focus stem,
every conv of ``dark2`` and ``dark3.0`` (eight at depth 0.33, twelve at
1.0); where ``depthwise``, a ``DWConv``'s ``pconv`` takes it and its
``dconv`` stays ``F.conv2d``.  Darknet: ``stem.*``, ``dark2.*`` and
``dark3.0`` (ten convs at depth 53, eight at 21; their lrelu launches the
kernel without its SiLU epilogue).  Every other conv stays ``F.conv2d``, as
they are XLA convs in the JAX package.  ``dtype`` is every conv's compute dtype
(``ops/blocks.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.blocks import (
    BaseConv,
    CSPLayer,
    Focus,
    ResLayer,
    SPPBottleneck,
    conv_class,
)

DEPTH2BLOCKS = {21: (1, 2, 2, 1), 53: (2, 8, 8, 4)}


class CSPDarknet(nn.Module):
    def __init__(self, dep_mul: float = 1.0, wid_mul: float = 1.0,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 act: str = "silu", dtype: torch.dtype = torch.float32,
                 depthwise: bool = False):
        super().__init__()
        self.out_features = tuple(out_features)
        base_ch = int(wid_mul * 64)
        base_depth = max(round(dep_mul * 3), 1)
        Conv = conv_class(depthwise)

        conv = dict(act=act, dtype=dtype)
        csp = dict(conv, depthwise=depthwise)
        kernel = dict(conv, phase_conv=True)
        self.stem = Focus(3, base_ch, ksize=3, **kernel)
        self.dark2 = nn.Sequential(
            Conv(base_ch, base_ch * 2, 3, 2, **kernel),
            CSPLayer(base_ch * 2, base_ch * 2, n=base_depth, phase_conv=True,
                     **csp),
        )
        self.dark3 = nn.Sequential(
            Conv(base_ch * 2, base_ch * 4, 3, 2, **kernel),
            CSPLayer(base_ch * 4, base_ch * 4, n=base_depth * 3, **csp),
        )
        self.dark4 = nn.Sequential(
            Conv(base_ch * 4, base_ch * 8, 3, 2, **conv),
            CSPLayer(base_ch * 8, base_ch * 8, n=base_depth * 3, **csp),
        )
        self.dark5 = nn.Sequential(
            Conv(base_ch * 8, base_ch * 16, 3, 2, **conv),
            SPPBottleneck(base_ch * 16, base_ch * 16, **conv),
            CSPLayer(base_ch * 16, base_ch * 16, n=base_depth, shortcut=False,
                     **csp),
        )

    def forward(self, x):
        outputs = {}
        x = self.stem(x)
        outputs["stem"] = x
        for name in ("dark2", "dark3", "dark4", "dark5"):
            x = getattr(self, name)(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}


def _group_layer(in_channels: int, num_blocks: int, dtype: torch.dtype,
                 kernel_conv: bool = False, kernel_res: bool = False):
    """A stride-2 conv to twice the channels, then ``num_blocks`` ResLayers
    (the reference's ``make_group_layer``); ``kernel_conv`` /
    ``kernel_res``: which of them take ``phase_conv``."""
    out = in_channels * 2
    return [BaseConv(in_channels, out, 3, 2, act="lrelu",
                     phase_conv=kernel_conv, dtype=dtype),
            *(ResLayer(out, phase_conv=kernel_res, dtype=dtype)
              for _ in range(num_blocks))]


def _spp_block(filters: Sequence[int], in_filters: int, dtype: torch.dtype):
    """conv 1x1, conv 3x3, SPP, conv 3x3, conv 1x1, all lrelu (the
    reference's ``make_spp_block``)."""
    f0, f1 = filters
    conv = dict(act="lrelu", dtype=dtype)
    return [BaseConv(in_filters, f0, 1, **conv), BaseConv(f0, f1, 3, **conv),
            SPPBottleneck(f1, f0, **conv), BaseConv(f0, f1, 3, **conv),
            BaseConv(f1, f0, 1, **conv)]


class Darknet(nn.Module):
    """The YOLOv3 residual backbone, depth 21 or 53 (reference ``Darknet``):
    ``dark3``, ``dark4``, ``dark5`` have 256, 512, 512 channels."""

    def __init__(self, depth: int = 53, stem_out_channels: int = 32,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_features = tuple(out_features)
        nb = DEPTH2BLOCKS[depth]
        c = stem_out_channels
        self.stem = nn.Sequential(
            BaseConv(3, c, 3, 1, act="lrelu", phase_conv=True, dtype=dtype),
            *_group_layer(c, 1, dtype, True, True))
        c *= 2  # 64
        self.dark2 = nn.Sequential(*_group_layer(c, nb[0], dtype, True, True))
        c *= 2  # 128
        self.dark3 = nn.Sequential(*_group_layer(c, nb[1], dtype, True))
        c *= 2  # 256
        self.dark4 = nn.Sequential(*_group_layer(c, nb[2], dtype))
        c *= 2  # 512
        self.dark5 = nn.Sequential(*_group_layer(c, nb[3], dtype),
                                   *_spp_block((c, c * 2), c * 2, dtype))

    def forward(self, x):
        outputs = {}
        for name in ("stem", "dark2", "dark3", "dark4", "dark5"):
            x = getattr(self, name)(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
