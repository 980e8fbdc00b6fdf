"""VGG19 backbone with YOLOX taps (counterpart of ``eop_tpu/models/vgg.py``).

Five conv-pool stages of (2, 2, 4, 4, 4) conv -> BN -> ReLU layers, each
ending in a 2x2 max pool, then a 1x1 ``conv_add`` lifting 512 channels to
1024, so the (dark3, dark4, dark5) taps carry 256, 512 and 1024 channels
whatever the neck's width.  Attribute names are the reference's:
``conv_pool{i}.{j}`` the j-th conv of stage i (its pool at index n), and
``conv_add``.  Every conv is ``F.conv2d`` (XLA convs in the JAX package).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.blocks import BaseConv

OUT_CHANNELS = (256, 512, 1024)


def conv_bn_relu(in_channels: int, out_channels: int, ksize: int = 3,
                 dtype: torch.dtype = torch.float32) -> BaseConv:
    """Conv (padding ``(k-1)//2``, no bias) -> BN -> ReLU: the reference's
    ``ConvBNReLU`` (``conv``, ``bn``)."""
    return BaseConv(in_channels, out_channels, ksize, act="relu", dtype=dtype)


class VGG(nn.Module):
    def __init__(self, layers: Sequence[int] = (2, 2, 4, 4, 4),
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_features = tuple(out_features)
        self.out_channels = OUT_CHANNELS
        c_in = 3
        for i, (n, c) in enumerate(zip(layers, (64, 128, 256, 512, 512)), 1):
            stage = [conv_bn_relu(c_in if j == 0 else c, c, dtype=dtype)
                     for j in range(n)]
            setattr(self, f"conv_pool{i}",
                    nn.Sequential(*stage, nn.MaxPool2d(2, 2)))
            c_in = c
        self.conv_add = conv_bn_relu(512, 1024, 1, dtype=dtype)

    def forward(self, x):
        outputs = {}
        for i, name in enumerate(("stem", "dark2", "dark3", "dark4"), 1):
            x = getattr(self, f"conv_pool{i}")(x)
            outputs[name] = x
        outputs["dark5"] = self.conv_add(self.conv_pool5(x))
        return {k: v for k, v in outputs.items() if k in self.out_features}


def vgg19(**kwargs) -> VGG:
    return VGG(layers=(2, 2, 4, 4, 4), **kwargs)
