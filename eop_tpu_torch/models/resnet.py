"""Half-width ResNet50 backbone with YOLOX taps (counterpart of
``eop_tpu/models/resnet.py``).

torchvision's Bottleneck ResNet with ``inplanes`` 32 and stage planes (32,
64, 128, 256): the x4 expansion puts the (dark3, dark4, dark5) taps on 256,
512 and 1024 channels.  A 7x7/s2 stem conv, BN, ReLU, a 3x3/s2 max pool
(padding 1), then ``layer1``..``layer4`` of (3, 4, 6, 3) blocks, the stride
on each stage's first 3x3 conv.  A block gets ``downsample`` (1x1 conv +
BN) where its stride is not 1 or its channels change.  Attribute names
are the reference's torch ones (``conv1``, ``bn1``, ``layer{i}.{j}.conv3``,
``layer{i}.{j}.downsample.{0,1}``); the reference's unused ``baseconv1-3``
and classifier are not built.  Every conv is ``F.conv2d`` in ``dtype``
(the blocks' dtype rules, ``ops/blocks.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.blocks import BN_EPS, BN_MOMENTUM, BatchNorm2d

EXPANSION = 4


def _conv(in_channels: int, out_channels: int, ksize: int,
          stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_channels, out_channels, ksize, stride,
                     (ksize - 1) // 2, bias=False)


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_in(conv: nn.Conv2d, x: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """``conv`` computed in ``dtype`` (input and weight cast) with its own
    stride and padding."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), each with BN, ReLU but after the
    last, plus the identity or ``downsample``."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * EXPANSION
        self.conv1, self.bn1 = _conv(in_channels, planes, 1), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1), _bn(out)
        self.downsample = (nn.Sequential(_conv(in_channels, out, 1, stride),
                                         _bn(out)) if downsample else None)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        out = F.relu(self.bn1(conv_in(self.conv1, x, dt)))
        out = F.relu(self.bn2(conv_in(self.conv2, out, dt)))
        out = self.bn3(conv_in(self.conv3, out, dt))
        identity = x.to(dt)
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv_in(conv, x, dt))
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block_counts: Sequence[int] = (3, 4, 6, 3),
                 inplanes: int = 32,
                 stage_planes: Sequence[int] = (32, 64, 128, 256),
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_features = tuple(out_features)
        self.out_channels = tuple(p * EXPANSION for p in stage_planes[1:])
        self.dtype = dtype
        self.conv1 = _conv(3, inplanes, 7, 2)
        self.bn1 = _bn(inplanes)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        c = inplanes
        for i, (planes, n) in enumerate(zip(stage_planes, block_counts), 1):
            stride = 1 if i == 1 else 2
            down = stride != 1 or c != planes * EXPANSION
            blocks = [Bottleneck(c, planes, stride, down, dtype)]
            c = planes * EXPANSION
            blocks += [Bottleneck(c, planes, dtype=dtype)
                       for _ in range(1, n)]
            setattr(self, f"layer{i}", nn.Sequential(*blocks))

    def forward(self, x):
        x = F.relu(self.bn1(conv_in(self.conv1, x, self.dtype)))
        outputs = {"stem": x}
        x = self.maxpool(x)
        for i, name in enumerate(("dark2", "dark3", "dark4", "dark5"), 1):
            x = getattr(self, f"layer{i}")(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}


def resnet50(**kwargs) -> ResNet:
    return ResNet(block_counts=(3, 4, 6, 3), **kwargs)
