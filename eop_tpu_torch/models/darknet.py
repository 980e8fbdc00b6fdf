"""CSPDarknet backbone (counterpart of ``eop_tpu/models/darknet.py``).

Same stages, channel progression and named taps (stem, dark2..dark5) as the
JAX ``CSPDarknet``; attribute names follow the reference
(``dark2.0`` = the stride-2 conv, ``dark2.1`` = the CSP layer, ``dark5.1``
= SPP, ``dark5.2`` = the last CSP layer).

The eight narrow early convs the TPU ``phase_conv`` kernel was written for
run through the port's Hopper ``phase_conv``: the Focus stem, ``dark2.0``,
the five convs of ``dark2.1`` (conv1, conv2, m.0.conv1, m.0.conv2, conv3 at
depth 0.33) and ``dark3.0``.  Every other conv stays ``F.conv2d``, as they
are XLA convs in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from ..ops.blocks import BaseConv, CSPLayer, Focus, SPPBottleneck


class CSPDarknet(nn.Module):
    def __init__(self, dep_mul: float = 1.0, wid_mul: float = 1.0,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5")):
        super().__init__()
        self.out_features = tuple(out_features)
        base_ch = int(wid_mul * 64)
        base_depth = max(round(dep_mul * 3), 1)

        self.stem = Focus(3, base_ch, ksize=3, phase_conv=True)
        self.dark2 = nn.Sequential(
            BaseConv(base_ch, base_ch * 2, 3, 2, phase_conv=True),
            CSPLayer(base_ch * 2, base_ch * 2, n=base_depth, phase_conv=True),
        )
        self.dark3 = nn.Sequential(
            BaseConv(base_ch * 2, base_ch * 4, 3, 2, phase_conv=True),
            CSPLayer(base_ch * 4, base_ch * 4, n=base_depth * 3),
        )
        self.dark4 = nn.Sequential(
            BaseConv(base_ch * 4, base_ch * 8, 3, 2),
            CSPLayer(base_ch * 8, base_ch * 8, n=base_depth * 3),
        )
        self.dark5 = nn.Sequential(
            BaseConv(base_ch * 8, base_ch * 16, 3, 2),
            SPPBottleneck(base_ch * 16, base_ch * 16),
            CSPLayer(base_ch * 16, base_ch * 16, n=base_depth, shortcut=False),
        )

    def forward(self, x):
        outputs = {}
        x = self.stem(x)
        outputs["stem"] = x
        for name in ("dark2", "dark3", "dark4", "dark5"):
            x = getattr(self, name)(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
