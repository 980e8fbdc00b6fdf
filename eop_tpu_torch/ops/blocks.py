"""Network building blocks (PyTorch, NCHW in channels_last memory).

Counterpart of ``eop_tpu/ops/blocks.py``, with the reference's torch
attribute names (``conv``, ``bn``, ``m.0``, ...) so a reference ``.pth`` or
a JAX export loads with ``strict=True``.

* BatchNorm uses eps 1e-3 and momentum 0.03, the values the reference stamps
  on every BN (JAX: ``BN_EPS``, ``BN_MOMENTUM`` in flax's convention).  In
  train mode :class:`BatchNorm2d` updates the running variance with the
  biased batch variance, as flax's ``nn.BatchNorm`` does.
* ``BaseConv(phase_conv=True)`` computes its convolution through
  :func:`eop_tpu_torch.ops.phase_conv.phase_conv`: the Hopper kernel on a
  CUDA tensor, its plain version on a CPU tensor.  Activations are NCHW
  tensors in channels_last memory, so ``x.permute(0, 2, 3, 1)`` is the
  kernel's contiguous NHWC input at no cost.  In eval mode without autograd
  the BatchNorm (folded to ``scale``, ``shift``; the form of
  ``eop_tpu/utils/model_utils.py::fuse_conv_bn``) and the SiLU go into the
  kernel's epilogue (SiLU is the only activation it has: a ``relu`` or
  ``lrelu`` conv launches the kernel without it and applies ``bn`` and
  ``act`` after); in train mode, or with autograd on, ``bn`` and ``act``
  run as modules and the convolution goes through
  :class:`eop_tpu_torch.ops.phase_conv.PhaseConvFunction`, whose backward
  launches the hand-written data- and weight-gradient kernels, so the
  gradient reaches ``conv.weight`` through the differentiable HWIO
  permutation (and the Focus fold).
* ``Focus`` computes the exact 6x6/s2 fold of space-to-depth + 3x3 conv
  (JAX ``_FoldedFocusConv``) while keeping the reference parameter shape
  ``[32, 12, 3, 3]``.
* ``dtype`` is the compute dtype, with flax's ``dtype`` semantics (the JAX
  blocks' ``dtype``, ``param_dtype=float32``): parameters and BatchNorm
  statistics stay fp32; each conv casts its input and weight to ``dtype``
  (the Focus weight is folded in fp32, then cast) and writes ``dtype``;
  BatchNorm computes its batch statistics in fp32 and writes the input's
  dtype; activations, residual adds and concats run in ``dtype``.  Under
  autograd the weight's cast is part of the graph, so the fp32 parameter
  gets the gradient.  The fused epilogue keeps fp32 ``scale``/``shift`` and
  rounds once where JAX rounds the conv's output to ``dtype`` before the
  BatchNorm.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from .phase_conv import phase_conv as _phase_conv

BN_MOMENTUM = 0.03  # torch convention; flax 0.97
BN_EPS = 1e-3
SPP_KERNELS = (5, 9, 13)

_frozen = threading.local()


@contextlib.contextmanager
def batch_stats_frozen():
    """Train-mode :class:`BatchNorm2d` inside this context normalises with
    the batch's statistics and leaves ``running_mean``, ``running_var`` and
    ``num_batches_tracked`` alone: the recompute context of a checkpointed
    forward (``YOLOX(remat=True)``), which must not count the batch twice,
    as JAX's functional ``nn.remat`` does not.  Per thread: the backward
    recomputes on its own thread."""
    before = getattr(_frozen, "on", False)
    _frozen.on = True
    try:
        yield
    finally:
        _frozen.on = before


def get_activation(name: str = "silu") -> nn.Module:
    """Activation by name, the registry of ``eop_tpu/ops/blocks.py``:
    ``silu``, ``relu``, ``lrelu`` (slope 0.1); any other name raises."""
    if name == "silu":
        return nn.SiLU()
    if name == "relu":
        return nn.ReLU()
    if name == "lrelu":
        return nn.LeakyReLU(0.1)
    raise AttributeError(f"Unsupported act type: {name}")


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode forward updates ``running_var``
    with the **biased** batch variance (flax's ``nn.BatchNorm``;
    ``nn.BatchNorm2d`` uses the unbiased one, a factor n/(n-1) per step that
    compounds into the running statistics, the EMA and eval).  Same
    parameters, buffers and normalisation as the parent.  A bf16 input is
    normalised with fp32 statistics and buffers and comes out bf16.  Under
    :func:`batch_stats_frozen` the buffers are not updated."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        n = x.numel() // x.shape[1]
        if n <= 1:
            raise ValueError("batch statistics need more than one value per "
                             f"channel, got input {tuple(x.shape)}")
        frozen = getattr(_frozen, "on", False)
        # F.batch_norm blends momentum * var * n / (n - 1) into a variance
        # buffer; hand it a scratch one and blend the biased variance (and,
        # frozen, a scratch mean too: the same kernel, no update)
        mean = (torch.zeros_like(self.running_mean) if frozen
                else self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        if frozen:
            return y
        with torch.no_grad():
            self.running_var.mul_(1.0 - self.momentum).add_(
                var, alpha=(n - 1) / n)
            self.num_batches_tracked += 1
        return y


class _MaxPool1dSame(torch.autograd.Function):
    """Stride-1 max pool of window ``ksize`` along ``dim`` with ``ksize//2``
    padding, whose backward splits the gradient **equally across tied
    maxima** of a window (the JAX ``_maxpool1d`` custom VJP;
    ``nn.MaxPool2d`` sends it to one position).  Padding never ties."""

    @staticmethod
    def forward(ctx, x, ksize, dim):
        pad = ksize // 2
        n = x.shape[dim]
        xp = _pad_dim(x, dim, pad, float("-inf"))
        y = xp.narrow(dim, 0, n)
        for u in range(1, ksize):
            y = torch.maximum(y, xp.narrow(dim, u, n))
        ctx.save_for_backward(x, y)
        ctx.pool = (ksize, dim)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        ksize, dim = ctx.pool
        pad = ksize // 2
        n = x.shape[dim]
        # ties[w] = #{i in window w : x[i] == y[w]} >= 1; NaN never compares
        # equal, so padding contributes nothing
        xp = _pad_dim(x, dim, pad, float("nan"))
        ties = torch.zeros_like(y)
        for u in range(ksize):
            ties = ties + (xp.narrow(dim, u, n) == y).to(y.dtype)
        gp = _pad_dim(g / ties, dim, pad, 0.0)
        yp = _pad_dim(y, dim, pad, float("nan"))
        dx = torch.zeros_like(x)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        for u in range(ksize):
            dx = dx + torch.where(x == yp.narrow(dim, u, n),
                                  gp.narrow(dim, u, n), zero)
        return dx, None, None


def _pad_dim(x: torch.Tensor, dim: int, pad: int, value: float):
    shape = list(x.shape)
    shape[dim] = pad
    edge = x.new_full(shape, value)
    return torch.cat([edge, x, edge], dim=dim)


def maxpool_same(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Stride-1 ``ksize x ksize`` max pool of an NCHW tensor with
    ``ksize//2`` padding, separably: along W, then along H (the order of the
    JAX ``_maxpool_same``, which decides how tied gradients split)."""
    return _MaxPool1dSame.apply(_MaxPool1dSame.apply(x, ksize, 3), ksize, 2)


class BaseConv(nn.Module):
    """Conv2d -> BatchNorm -> ``act``, torch-"same" padding ``(k-1)//2``.

    ``groups`` > 1 is a grouped convolution (``DWConv``'s depthwise one),
    always ``F.conv2d``: ``eop_tpu`` computes it with XLA's
    ``feature_group_count``, never in Pallas.
    ``phase_conv`` routes the convolution through the ``phase_conv`` kernel.
    The kernel's HWIO weight (in ``dtype``) and the folded BatchNorm are
    derived from the parameters once and cached while the module runs in
    eval mode without autograd; the caches follow the tensors' versions, so
    ``load_state_dict`` refreshes them.
    """

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, act: str = "silu", phase_conv: bool = False,
                 dtype: torch.dtype = torch.float32, groups: int = 1):
        super().__init__()
        if phase_conv and groups != 1:
            raise ValueError("phase_conv computes ungrouped convolutions only")
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                              (ksize - 1) // 2, groups=groups, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = get_activation(act)
        self.act_name = act
        self.phase_conv = phase_conv
        self.dtype = dtype
        # (key, value) pairs, each replaced by one assignment, so that a
        # thread reading a cache never pairs a key with another key's value
        self._hwio_cache = (None, None)
        self._bn_cache = (None, None)

    def conv_args(self):
        """(OIHW weight in ``dtype``, stride, padding) of the convolution
        computed."""
        return (self.conv.weight.to(self.dtype), self.conv.stride[0],
                self.conv.padding[0])

    def _hwio_args(self):
        """(HWIO weight in ``dtype``, stride, padding) for the kernel."""
        # the cached tensor carries no graph: only for eval without autograd,
        # and never while torch.export traces (no data pointers there)
        cacheable = (not self.training and not torch.is_grad_enabled()
                     and not torch.compiler.is_compiling())
        if not cacheable:
            w, stride, pad = self.conv_args()
            return w.permute(2, 3, 1, 0).contiguous(), stride, pad
        p = self.conv.weight
        # the parameter stays fp32: key on the dtype the cache holds
        key = (p.data_ptr(), p._version, self.dtype)
        cached_key, cached = self._hwio_cache
        if cached_key == key:
            return cached
        w, stride, pad = self.conv_args()
        args = (w.permute(2, 3, 1, 0).contiguous(), stride, pad)
        self._hwio_cache = (key, args)
        return args

    def _folded_bn(self):
        """Eval-mode BatchNorm as fp32 (scale, shift):
        ``scale = gamma / sqrt(running_var + eps)``,
        ``shift = beta - running_mean * scale``; cached, except while
        ``torch.export`` traces."""
        bn = self.bn
        tracing = torch.compiler.is_compiling()
        key = None if tracing else tuple((t.data_ptr(), t._version) for t in (
            bn.weight, bn.bias, bn.running_mean, bn.running_var))
        cached_key, cached = self._bn_cache
        if key is not None and cached_key == key:
            return cached
        scale = bn.weight.float() * torch.rsqrt(
            bn.running_var.float() + bn.eps)
        shift = bn.bias.float() - bn.running_mean.float() * scale
        folded = (scale.contiguous(), shift.contiguous())
        if key is not None:
            self._bn_cache = (key, folded)
        return folded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.phase_conv:
            w, stride, pad = self._hwio_args()
            x_nhwc = x.contiguous(memory_format=torch.channels_last).permute(
                0, 2, 3, 1)
            if (not self.training and not torch.is_grad_enabled()
                    and self.act_name == "silu"):
                scale, shift = self._folded_bn()
                return _phase_conv(x_nhwc, w, stride, pad, scale, shift,
                                   "silu").permute(0, 3, 1, 2)
            y = _phase_conv(x_nhwc, w, stride, pad).permute(0, 3, 1, 2)
        else:
            w, stride, pad = self.conv_args()
            y = F.conv2d(x, w, None, stride, pad, groups=self.conv.groups)
        return self.act(self.bn(y))


class DWConv(nn.Module):
    """Depthwise conv + pointwise conv (reference ``DWConv``): ``dconv`` is
    the ``ksize`` conv grouped by channel (``F.conv2d``), ``pconv`` the 1x1
    conv, which takes ``phase_conv`` where asked."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, act: str = "silu", phase_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dconv = BaseConv(in_channels, in_channels, ksize, stride,
                              act=act, dtype=dtype, groups=in_channels)
        self.pconv = BaseConv(in_channels, out_channels, 1, act=act,
                              phase_conv=phase_conv, dtype=dtype)

    def forward(self, x):
        return self.pconv(self.dconv(x))


def conv_class(depthwise: bool):
    """The 3x3 conv of a block: :class:`DWConv` where ``depthwise``."""
    return DWConv if depthwise else BaseConv


class Bottleneck(nn.Module):
    """Bottleneck (reference ``Bottleneck`` as CSPLayer builds it:
    expansion 1.0, channels in == out; ``conv2`` a :class:`DWConv` where
    ``depthwise``)."""

    def __init__(self, channels: int, shortcut: bool = True,
                 act: str = "silu", phase_conv: bool = False,
                 dtype: torch.dtype = torch.float32, depthwise: bool = False):
        super().__init__()
        conv = dict(act=act, phase_conv=phase_conv, dtype=dtype)
        self.conv1 = BaseConv(channels, channels, 1, **conv)
        self.conv2 = conv_class(depthwise)(channels, channels, 3, **conv)
        self.use_add = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class ResLayer(nn.Module):
    """YOLOv3's residual layer (reference ``ResLayer``): a 1x1 conv to half
    the channels, a 3x3 conv back, both lrelu, plus the input."""

    def __init__(self, channels: int, phase_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = dict(act="lrelu", phase_conv=phase_conv, dtype=dtype)
        self.layer1 = BaseConv(channels, channels // 2, 1, **conv)
        self.layer2 = BaseConv(channels // 2, channels, 3, **conv)

    def forward(self, x):
        return x + self.layer2(self.layer1(x))


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (reference ``SPPBottleneck``).  Without
    autograd the pools are ``nn.MaxPool2d``; with it they are
    :func:`maxpool_same`, the same values with the JAX backward that splits
    the gradient equally across tied maxima."""

    def __init__(self, in_channels: int, out_channels: int,
                 act: str = "silu", dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = BaseConv(in_channels, hidden, 1, act=act, dtype=dtype)
        self.m = nn.ModuleList(
            nn.MaxPool2d(ks, stride=1, padding=ks // 2) for ks in SPP_KERNELS)
        self.conv2 = BaseConv(hidden * (len(SPP_KERNELS) + 1), out_channels, 1,
                              act=act, dtype=dtype)

    def forward(self, x):
        x = self.conv1(x)
        if torch.is_grad_enabled() and x.requires_grad:
            pools = [maxpool_same(x, m.kernel_size) for m in self.m]
        else:
            pools = [m(x) for m in self.m]
        return self.conv2(torch.cat([x] + pools, dim=1))


class CSPLayer(nn.Module):
    """C3 CSP bottleneck with 3 convs (reference ``CSPLayer``, expansion
    0.5; the bottlenecks' 3x3 convs are :class:`DWConv` where
    ``depthwise``)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, act: str = "silu",
                 phase_conv: bool = False, dtype: torch.dtype = torch.float32,
                 depthwise: bool = False):
        super().__init__()
        hidden = out_channels // 2
        conv = dict(act=act, phase_conv=phase_conv, dtype=dtype)
        self.conv1 = BaseConv(in_channels, hidden, 1, **conv)
        self.conv2 = BaseConv(in_channels, hidden, 1, **conv)
        self.conv3 = BaseConv(2 * hidden, out_channels, 1, **conv)
        self.m = nn.Sequential(*(
            Bottleneck(hidden, shortcut, depthwise=depthwise, **conv)
            for _ in range(n)))

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
    convolution is its 2k x 2k stride-2 fold, folded in fp32 and then cast
    to ``dtype`` (JAX's order: the other rounds differently)."""

    def conv_args(self):
        k = self.conv.kernel_size[0]
        return (fold_focus_weight(self.conv.weight).to(self.dtype), 2,
                2 * ((k - 1) // 2))


class Focus(nn.Module):
    """Focus width/height into channels (reference ``Focus``), computed as
    the folded stride-2 conv over the raw image."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 1,
                 act: str = "silu", phase_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = _FoldedFocusConv(in_channels * 4, out_channels, ksize,
                                     act=act, phase_conv=phase_conv,
                                     dtype=dtype)

    def forward(self, x):
        return self.conv(x)
