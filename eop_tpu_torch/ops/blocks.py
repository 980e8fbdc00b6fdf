"""Network building blocks (PyTorch, NCHW in channels_last memory).

Counterpart of ``eop_tpu/ops/blocks.py``, with the reference's torch
attribute names (``conv``, ``bn``, ``m.0``, ...) so a reference ``.pth`` or
a JAX export loads with ``strict=True``.

* BatchNorm uses eps 1e-3 and momentum 0.03, the values the reference stamps
  on every BN (JAX: ``BN_EPS``, ``BN_MOMENTUM`` in flax's convention).
* ``BaseConv(phase_conv=True)`` computes its convolution through
  :func:`eop_tpu_torch.ops.phase_conv.phase_conv`: the Hopper kernel on a
  CUDA tensor, its plain version on a CPU tensor.  Activations are NCHW
  tensors in channels_last memory, so ``x.permute(0, 2, 3, 1)`` is the
  kernel's contiguous NHWC input at no cost.
* ``Focus`` computes the exact 6x6/s2 fold of space-to-depth + 3x3 conv
  (JAX ``_FoldedFocusConv``) while keeping the reference parameter shape
  ``[32, 12, 3, 3]``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .phase_conv import phase_conv as _phase_conv

BN_MOMENTUM = 0.03  # torch convention; flax 0.97
BN_EPS = 1e-3
SPP_KERNELS = (5, 9, 13)


class BaseConv(nn.Module):
    """Conv2d -> BatchNorm -> SiLU, torch-"same" padding ``(k-1)//2``.

    ``phase_conv`` routes the convolution through the ``phase_conv`` kernel.
    The kernel's HWIO weight is derived from the OIHW parameter once and
    cached while the module runs without autograd.
    """

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, phase_conv: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                              (ksize - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS,
                                 momentum=BN_MOMENTUM)
        self.act = nn.SiLU()
        self.phase_conv = phase_conv
        self._hwio_key = None
        self._hwio_cached = None

    def conv_args(self):
        """(OIHW weight, stride, padding) of the convolution computed."""
        return self.conv.weight, self.conv.stride[0], self.conv.padding[0]

    def _hwio_args(self):
        """(HWIO weight, stride, padding) for the kernel."""
        p = self.conv.weight
        key = (p.data_ptr(), p._version, p.dtype)
        if self._hwio_key == key:
            return self._hwio_cached
        w, stride, pad = self.conv_args()
        args = (w.permute(2, 3, 1, 0).contiguous(), stride, pad)
        if not self.training and not torch.is_grad_enabled():
            self._hwio_key, self._hwio_cached = key, args
        return args

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.phase_conv:
            w, stride, pad = self._hwio_args()
            x_nhwc = x.contiguous(memory_format=torch.channels_last).permute(
                0, 2, 3, 1)
            y = _phase_conv(x_nhwc, w, stride, pad).permute(0, 3, 1, 2)
        else:
            w, stride, pad = self.conv_args()
            y = F.conv2d(x, w, None, stride, pad)
        return self.act(self.bn(y))


class Bottleneck(nn.Module):
    """Bottleneck (reference ``Bottleneck`` as CSPLayer builds it:
    expansion 1.0, channels in == out)."""

    def __init__(self, channels: int, shortcut: bool = True,
                 phase_conv: bool = False):
        super().__init__()
        self.conv1 = BaseConv(channels, channels, 1, phase_conv=phase_conv)
        self.conv2 = BaseConv(channels, channels, 3, phase_conv=phase_conv)
        self.use_add = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (reference ``SPPBottleneck``).  Forward
    values equal the JAX separable pools with ``k//2`` padding; the JAX
    tie-splitting backward is not needed for serving."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = BaseConv(in_channels, hidden, 1)
        self.m = nn.ModuleList(
            nn.MaxPool2d(ks, stride=1, padding=ks // 2) for ks in SPP_KERNELS)
        self.conv2 = BaseConv(hidden * (len(SPP_KERNELS) + 1), out_channels, 1)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [m(x) for m in self.m], dim=1))


class CSPLayer(nn.Module):
    """C3 CSP bottleneck with 3 convs (reference ``CSPLayer``, expansion
    0.5)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, phase_conv: bool = False):
        super().__init__()
        hidden = out_channels // 2
        self.conv1 = BaseConv(in_channels, hidden, 1, phase_conv=phase_conv)
        self.conv2 = BaseConv(in_channels, hidden, 1, phase_conv=phase_conv)
        self.conv3 = BaseConv(2 * hidden, out_channels, 1,
                              phase_conv=phase_conv)
        self.m = nn.Sequential(*(
            Bottleneck(hidden, shortcut, phase_conv) for _ in range(n)))

    def forward(self, x):
        x1 = self.m(self.conv1(x))
        x2 = self.conv2(x)
        return self.conv3(torch.cat([x1, x2], dim=1))


def fold_focus_weight(w: torch.Tensor) -> torch.Tensor:
    """Focus kernel OIHW ``[Co, 4C, k, k]`` -> the equivalent 2k x 2k
    stride-2 kernel ``[Co, C, 2k, 2k]`` over the raw image.

    Space-to-depth group g = (di, dj) (order tl, bl, tr, br) channel c sits
    at pixel offset (2a + di, 2b + dj); this is the tap placement of the JAX
    ``_focus_fold_const``, written as strided assignment (exact)."""
    co, c4, k, _ = w.shape
    c = c4 // 4
    w5 = w.reshape(co, 4, c, k, k)
    out = w.new_zeros((co, c, 2 * k, 2 * k))
    for g, (di, dj) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        out[:, :, di::2, dj::2] = w5[:, g]
    return out


class _FoldedFocusConv(BaseConv):
    """BaseConv whose parameter is the reference Focus kernel and whose
    convolution is its 2k x 2k stride-2 fold."""

    def conv_args(self):
        k = self.conv.kernel_size[0]
        return fold_focus_weight(self.conv.weight), 2, 2 * ((k - 1) // 2)


class Focus(nn.Module):
    """Focus width/height into channels (reference ``Focus``), computed as
    the folded stride-2 conv over the raw image."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 1,
                 phase_conv: bool = False):
        super().__init__()
        self.conv = _FoldedFocusConv(in_channels * 4, out_channels, ksize,
                                     phase_conv=phase_conv)

    def forward(self, x):
        return self.conv(x)
