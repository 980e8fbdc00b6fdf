"""DenseNet121 backbone with YOLOX taps (counterpart of
``eop_tpu/models/densenet.py``).

Growth rate 32, dense blocks of (6, 12, 24, 16) layers, transitions that
halve the channels (1x1 conv, 2x2 average pool), and 1x1 ``baseconv1/2``
projections, so the taps are dark3 = 256 (from D2's 512), dark4 = 512
(from D3's 1024) and dark5 = 1024 (D4).  A dense layer is two
pre-activation convs (BN -> ReLU -> conv: 1x1 to 128, 3x3 to 32) and, in
training, channel dropout at ``drop_rate`` 0.3 (torch's ``Dropout2d``,
flax's ``Dropout(broadcast_dims=(1, 2))``): one keep draw per (sample,
channel), kept values scaled by ``1 / (1 - p)``.

The masks come from :class:`ChannelDropout`'s own ``torch.Generator`` on
the activations' device, seeded explicitly (``reseed``; the exp seeds it
with the model seed, and the trainer each step with :func:`step_seed` of
its seed and the step), never from the global RNG.  Under
``YOLOX(remat=True)`` the recompute must draw the forward's masks again:
``torch.utils.checkpoint`` restores only the global RNG, so the
checkpoint's contexts save and restore the generator's state
(:func:`eop_tpu_torch.models.yolox._remat_contexts`).

Attribute names are the reference's torch ones: ``stem.0`` (conv, bn),
``D{i}.denseblock.{j}.conv_block.{0,1}`` (bn, conv), ``T{i}.trans.0``,
``baseconv1/2``.  Every conv is ``F.conv2d`` in ``dtype``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.blocks import BN_EPS, BN_MOMENTUM, BaseConv, BatchNorm2d


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed for training step ``step`` of a run
    seeded ``seed``: a step's masks depend on the two alone, so a resumed
    run draws those of an uninterrupted one (``eop_tpu`` keys each step's
    dropout ``PRNGKey(step)``)."""
    return (int(seed) << 32) + int(step)


class ChannelDropout:
    """Channel dropout with a generator of its own, shared by every dense
    layer of one DenseNet."""

    def __init__(self, p: float, seed: int = 0):
        self.p = float(p)
        self.seed = int(seed)
        self._gen: Optional[torch.Generator] = None
        # (rank, world): under data parallelism each rank draws the global
        # batch's masks and keeps its rows, so the ranks' masks are the ones
        # one process draws for the global batch
        self.shard = (0, 1)

    def generator(self, device: torch.device) -> torch.Generator:
        """The generator on ``device``, made from ``seed`` on first use
        there."""
        device = torch.device(device)
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device)
            self._gen.manual_seed(self.seed)
        return self._gen

    def reseed(self, seed: int):
        """Start the draws again from ``seed``."""
        self.seed = int(seed)
        if self._gen is not None:
            self._gen.manual_seed(self.seed)

    def get_state(self):
        return None if self._gen is None else self._gen.get_state()

    def set_state(self, state):
        if state is None:
            self._gen = None
        else:
            self._gen.set_state(state)

    def keep_mask(self, shape, device) -> torch.Tensor:
        """The next draw: True where a channel is kept (this rank's rows of
        the global batch's draw under ``shard``)."""
        rank, world = self.shard
        b = shape[0]
        draw = torch.rand((b * world, *shape[1:]), device=device,
                          generator=self.generator(device))
        return draw[rank * b:(rank + 1) * b] < 1.0 - self.p

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        mask = self.keep_mask((x.shape[0], x.shape[1], 1, 1), x.device)
        return torch.where(mask, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class ConvBlock(nn.Module):
    """BN -> ReLU -> conv (pre-activation; reference ``ConvBlock``)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn = BatchNorm2d(in_channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, 1,
                              (ksize - 1) // 2, bias=False)
        self.dtype = dtype

    def forward(self, x):
        x = F.relu(self.bn(x.to(self.dtype)))
        return F.conv2d(x, self.conv.weight.to(self.dtype), None, 1,
                        self.conv.padding)


class DenseLayer(nn.Module):
    """1x1 (``bn_size * growth``) -> 3x3 (``growth``), then channel dropout
    in training."""

    def __init__(self, in_channels: int, growth_rate: int = 32,
                 bn_size: int = 4, dropout: Optional[ChannelDropout] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = bn_size * growth_rate
        self.conv_block = nn.Sequential(
            ConvBlock(in_channels, mid, 1, dtype),
            ConvBlock(mid, growth_rate, 3, dtype))
        self.dropout = dropout

    def forward(self, x):
        y = self.conv_block(x)
        if self.training and self.dropout is not None and self.dropout.p > 0:
            y = self.dropout(y)
        return y


class DenseBlock(nn.Module):
    """``num_layers`` dense layers, each concatenating its growth."""

    def __init__(self, in_channels: int, num_layers: int,
                 growth_rate: int = 32,
                 dropout: Optional[ChannelDropout] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.denseblock = nn.ModuleList(
            DenseLayer(in_channels + i * growth_rate, growth_rate,
                       dropout=dropout, dtype=dtype)
            for i in range(num_layers))
        self.out_channels = in_channels + num_layers * growth_rate

    def forward(self, x):
        for layer in self.denseblock:
            x = torch.cat([x, layer(x)], dim=1)
        return x


class Transition(nn.Module):
    """1x1 pre-activation conv + 2x2 average pool."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trans = nn.Sequential(
            ConvBlock(in_channels, out_channels, 1, dtype),
            nn.AvgPool2d(2, 2))

    def forward(self, x):
        return self.trans(x)


class DenseNet(nn.Module):
    def __init__(self, growth_rate: int = 32,
                 block_layers: Sequence[int] = (6, 12, 24, 16),
                 num_init_channels: int = 64, drop_rate: float = 0.3,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_features = tuple(out_features)
        g, bl = growth_rate, block_layers
        self.dropout = ChannelDropout(drop_rate)
        kw = dict(dropout=self.dropout, dtype=dtype)
        self.stem = nn.Sequential(
            BaseConv(3, num_init_channels, 7, 2, act="relu", dtype=dtype),
            nn.MaxPool2d(3, 2, 1))
        c = num_init_channels
        for i in range(1, 5):
            block = DenseBlock(c, bl[i - 1], g, **kw)
            setattr(self, f"D{i}", block)
            c = block.out_channels
            if i < 4:
                setattr(self, f"T{i}", Transition(c, c // 2, dtype))
                if i > 1:
                    setattr(self, f"baseconv{i - 1}",
                            BaseConv(c, c // 2, 1, act="relu", dtype=dtype))
                c //= 2
        self.out_channels = (self.baseconv1.conv.out_channels,
                             self.baseconv2.conv.out_channels, c)

    def forward(self, x):
        x = self.stem(x)
        outputs = {"stem": x}
        x = self.D1(x)
        outputs["dark2"] = x
        x = self.D2(self.T1(x))
        outputs["dark3"] = self.baseconv1(x)
        x = self.D3(self.T2(x))
        outputs["dark4"] = self.baseconv2(x)
        outputs["dark5"] = self.D4(self.T3(x))
        return {k: v for k, v in outputs.items() if k in self.out_features}


def densenet121(**kwargs) -> DenseNet:
    return DenseNet(growth_rate=32, block_layers=(6, 12, 24, 16), **kwargs)
