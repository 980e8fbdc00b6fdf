"""Post-training int8 quantization for inference and serving (counterpart
of ``eop_tpu/ops/quant.py``).

Symmetric PTQ, as ``eop_tpu`` computes it:

* **weights**: per output channel, ``s_w = absmax / 127`` (1 where a
  channel is all zero), codes ``clip(round(w / s_w), -127, 127)``, rounded
  half to even (:func:`quantize_kernel`);
* **activations**: one scale a conv, ``s_x = absmax / 127`` with the max
  taken over every calibration batch (:func:`calibrate_act_scales`), codes
  ``clip(round(x / s_x), -127, 127)``;
* **accumulation**: an int32 convolution of the codes, exact
  (:func:`int8_conv`), then ``acc * (s_x * s_w) (+ bias)`` in fp32, cast to
  the module's compute dtype.

Which convs: an ungrouped, undilated 2-D conv with ``min(C_in, C_out) >=
min_channels`` (``eop_tpu``'s ``_eligible``) among the convs the quantizer
reaches (:func:`conv_sites`): every ``BaseConv`` but the folded Focus stem
(no ``nn.Conv`` in ``eop_tpu``, so never quantized there), keyed
``<module>.conv`` as ``eop_tpu`` keys ``<module>/conv``, and the head's
prediction convs, keyed by their own names.  The port's ResNet and DenseNet
blocks call ``F.conv2d`` on their weights, which no hook reaches: a model
with such a conv past the gate raises rather than quantize part of what
``eop_tpu`` quantizes.  Observation uses forward pre-hooks on those modules
(:func:`observing`), in place of ``eop_tpu``'s flax interceptor; the
quantized model is a copy with each eligible, calibrated conv swapped for a
:class:`QuantBaseConv` or :class:`QuantConv2d` (:func:`quantize_model`).  A
conv without a scale keeps its fp path.  The head's prediction convs are
hooked through their module call, which the head makes in fp32 only: int8
PTQ of a bf16 model raises (ROADMAP.md queue 1 item 5).

``eop_tpu``'s ``packed_act_scale`` belongs to the packed layout, which the
port does not have (ROADMAP.md queue 1 item 9), and has no counterpart here.

The int32 convolution is a library product, as in ``eop_tpu`` (an XLA conv
with ``preferred_element_type=int32``), not a port of a TPU kernel: the
patches of the int8 codes, then ``torch._int_mm`` (cuBLASLt on the card,
exact int32).  It is the registered operator ``eop_tpu_torch::int8_conv``,
counted in ``int8_conv.calls`` (and ``.off_phase_conv``, those that
replace a ``phase_conv`` conv), inside an exported program too.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Iterable, Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .phase_conv import out_hw

INT8_MAX = 127.0


def conv_sites(model: nn.Module) -> Dict[str, nn.Module]:
    """Scale key -> module of every conv the quantizer reaches:
    ``f"{name}.conv"`` -> each ``BaseConv`` (its convolution) but the folded
    Focus stem, ``name`` -> each prediction conv of a ``YOLOXHead``."""
    from ..models.head import YOLOXHead
    from .blocks import BaseConv, _FoldedFocusConv

    sites = {}
    for name, m in model.named_modules():
        if isinstance(m, BaseConv) and not isinstance(m, _FoldedFocusConv):
            sites[f"{name}.conv"] = m
        elif isinstance(m, YOLOXHead):
            for group in ("cls_preds", "reg_preds", "obj_preds"):
                for i, conv in enumerate(getattr(m, group)):
                    sites[f"{name}.{group}.{i}"] = conv
    return sites


def _conv(module: nn.Module) -> nn.Conv2d:
    return module if isinstance(module, nn.Conv2d) else module.conv


def eligible(module: nn.Module, min_channels: int) -> bool:
    """``eop_tpu``'s ``_eligible``: ungrouped, undilated, 2-D, and
    ``min(C_in, C_out) >= min_channels``."""
    conv = _conv(module)
    return (conv.groups == 1 and tuple(conv.dilation) == (1, 1)
            and len(conv.kernel_size) == 2
            and min(conv.in_channels, conv.out_channels) >= min_channels)


def _check_reachable(model: nn.Module, min_channels: int) -> None:
    """Raise for an ungrouped conv past the gate that no site covers (the
    ResNet and DenseNet blocks' ``F.conv2d`` calls); the Focus stem is left
    out on purpose."""
    from .blocks import _FoldedFocusConv

    covered = {id(_conv(m)) for m in conv_sites(model).values()} | {
        id(m.conv) for m in model.modules()
        if isinstance(m, _FoldedFocusConv)}
    for name, m in model.named_modules():
        if (isinstance(m, nn.Conv2d) and id(m) not in covered
                and eligible(m, min_channels)):
            raise NotImplementedError(
                f"int8 PTQ reaches no hook on conv {name!r} (ResNet's and "
                "DenseNet's blocks call F.conv2d): not ported, ROADMAP.md "
                "queue 1 item 5")


def _check_dtype(model: nn.Module) -> None:
    from ..models.head import YOLOXHead

    for m in model.modules():
        if isinstance(m, YOLOXHead) and m.dtype != torch.float32:
            raise NotImplementedError(
                f"int8 PTQ of a {m.dtype} model: the head's prediction "
                "convs run their module only in float32 (ROADMAP.md queue 1 "
                "item 5)")


@contextlib.contextmanager
def observing(model: nn.Module, min_channels: int = 64):
    """Record each eligible conv input's absmax while the block runs:
    yields a dict ``key -> fp32 0-dim tensor`` (the running max over every
    call), filled by forward pre-hooks (``eop_tpu``'s
    ``observe_interceptor``)."""
    _check_dtype(model)
    _check_reachable(model, min_channels)
    stats: Dict[str, torch.Tensor] = {}

    def hook_for(key):
        def hook(_module, args):
            a = args[0].detach().float().abs().amax()
            prev = stats.get(key)
            stats[key] = a if prev is None else torch.maximum(prev, a)
        return hook

    handles = [m.register_forward_pre_hook(hook_for(key))
               for key, m in conv_sites(model).items()
               if eligible(m, min_channels)]
    try:
        yield stats
    finally:
        for h in handles:
            h.remove()


def calibrate_act_scales(observe_fn: Callable[[object], Mapping],
                         batches: Iterable) -> Dict[str, float]:
    """``observe_fn(batch)`` -> ``{key: absmax}`` for each calibration
    batch; returns ``{key: absmax / 127}`` with the max taken over all
    batches, for each key whose absmax is positive (``eop_tpu``'s
    ``calibrate_act_scales``)."""
    running: Dict[str, float] = {}
    for batch in batches:
        for key, absmax in observe_fn(batch).items():
            running[key] = max(running.get(key, 0.0), float(absmax))
    return {key: absmax / INT8_MAX for key, absmax in running.items()
            if absmax > 0.0}


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an OIHW weight, computed in fp32
    on the CPU (the same bits whatever device serves it): (int8 codes OIHW,
    fp32 ``s_w [O]``)."""
    w = w.detach().float().cpu()
    absmax = w.abs().amax(dim=(1, 2, 3))
    s_w = torch.where(absmax > 0.0, absmax / INT8_MAX,
                      torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / s_w[:, None, None, None]),
                    -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), s_w


def quantize_act(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s_x), -127, 127)`` as int8, in fp32.  ``s_x`` is a
    tensor on ``x``'s device: a true division on the card as on the CPU
    (a Python scalar divisor becomes a reciprocal multiply there)."""
    return torch.clamp(torch.round(x.float() / s_x), -INT8_MAX,
                       INT8_MAX).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8`` -> int32 ``[M, N]``, exact, through
    ``torch._int_mm``, whose CUDA version takes M > 16 and K, N multiples of
    8: rows, the inner and the outer dimension are padded with zeros where
    they fall short (on every device, so the CPU tests run the padding) and
    the result cut back."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        # padded as its transpose: a column-major b stays column-major
        b = F.pad(b.t(), (0, kp - k, 0, np_ - n)).t()
    out = torch._int_mm(a.contiguous(), b)
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_patches(q_x: torch.Tensor, k: int, stride: int,
                 padding: int) -> torch.Tensor:
    """The ``[B * Ho * Wo, k * k * C]`` patches of NHWC int8 codes, taps in
    (ky, kx, c) order, zeros outside the image."""
    b, h, w, c = q_x.shape
    if k == 1 and stride == 1:
        return q_x.reshape(b * h * w, c)
    ho, wo = out_hw(h, w, k, stride, padding)
    xp = F.pad(q_x, (0, 0, padding, padding, padding, padding))
    taps = [xp[:, ky: ky + stride * (ho - 1) + 1: stride,
               kx: kx + stride * (wo - 1) + 1: stride]
            for ky in range(k) for kx in range(k)]
    return torch.cat(taps, dim=-1).reshape(b * ho * wo, k * k * c)


def _int8_conv(q_x, q_w, k, stride, padding, off_phase_conv):
    b, h, w, _ = q_x.shape
    ho, wo = out_hw(h, w, k, stride, padding)
    acc = int_mm_padded(int8_patches(q_x, k, stride, padding), q_w)
    int8_conv.calls += 1
    int8_conv.off_phase_conv += bool(off_phase_conv)
    return acc.reshape(b, ho, wo, q_w.shape[1])


@torch.library.custom_op("eop_tpu_torch::int8_conv", mutates_args=())
def int8_conv_op(q_x: torch.Tensor, q_w: torch.Tensor, k: int, stride: int,
                 padding: int, off_phase_conv: bool) -> torch.Tensor:
    """:func:`int8_conv` as a registered operator (one node of an exported
    graph), counted where it runs."""
    return _int8_conv(q_x, q_w, k, stride, padding, off_phase_conv)


@int8_conv_op.register_fake
def _int8_conv_fake(q_x, q_w, k, stride, padding, off_phase_conv):
    ho, wo = out_hw(q_x.shape[1], q_x.shape[2], k, stride, padding)
    return q_x.new_empty((q_x.shape[0], ho, wo, q_w.shape[1]),
                         dtype=torch.int32)


def int8_conv(q_x: torch.Tensor, q_w: torch.Tensor, k: int, stride: int,
              padding: int, off_phase_conv: bool = False) -> torch.Tensor:
    """int32 NHWC ``[B, Ho, Wo, Co]`` convolution of NHWC int8 codes ``q_x``
    by ``q_w`` ``[k * k * C, Co]`` (taps in (ky, kx, c) order; the transpose
    of a contiguous ``[Co, k * k * C]``) with symmetric ``padding``:
    :func:`int8_patches`, then :func:`int_mm_padded`.  Exact, equal to
    ``eop_tpu``'s ``lax.conv_general_dilated(...,
    preferred_element_type=int32)``.  ``off_phase_conv`` says that the fp
    model computes this conv with ``phase_conv``.  Counters:
    ``int8_conv.calls``, ``int8_conv.off_phase_conv``.  The registered
    operator while ``torch.export`` traces, its body eagerly (a custom op's
    first call imports torch._dynamo)."""
    if torch.compiler.is_compiling():
        return int8_conv_op(q_x, q_w, k, stride, padding, off_phase_conv)
    return _int8_conv(q_x, q_w, k, stride, padding, off_phase_conv)


int8_conv.calls = 0           # int8 convolutions computed
int8_conv.off_phase_conv = 0  # of them, convs that phase_conv computes in fp


class QuantConv2d(nn.Module):
    """An eligible conv computed in int8 (``eop_tpu``'s
    ``quant_interceptor``): NCHW in, NCHW (channels_last) out in
    ``out_dtype``; ``bias`` added in fp32 after the dequantization."""

    def __init__(self, conv: nn.Conv2d, s_x: float, out_dtype: torch.dtype,
                 off_phase_conv: bool = False):
        super().__init__()
        q_w, s_w = quantize_kernel(conv.weight)
        co = q_w.shape[0]
        device = conv.weight.device
        s_x32 = torch.tensor(s_x, dtype=torch.float32)
        # [Co, ky, kx, C] rows, so the patches' (ky, kx, c) order
        self.register_buffer("q_w", q_w.permute(0, 2, 3, 1).reshape(
            co, -1).to(device).t())
        self.register_buffer("s_x", s_x32.to(device))
        self.register_buffer("dequant", (s_x32 * s_w).to(device))
        self.register_buffer("bias", None if conv.bias is None
                             else conv.bias.detach().float().clone())
        self.k, self.stride = conv.kernel_size[0], conv.stride[0]
        self.padding = conv.padding[0]
        self.out_dtype = out_dtype
        self.off_phase_conv = off_phase_conv

    def accumulate(self, x: torch.Tensor) -> torch.Tensor:
        """The int32 NHWC accumulator of NCHW input ``x``."""
        x_nhwc = x.contiguous(memory_format=torch.channels_last).permute(
            0, 2, 3, 1)
        return int8_conv(quantize_act(x_nhwc, self.s_x), self.q_w, self.k,
                         self.stride, self.padding, self.off_phase_conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.accumulate(x).float() * self.dequant
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.out_dtype).permute(0, 3, 1, 2)


class QuantBaseConv(nn.Module):
    """A ``BaseConv`` whose convolution is a :class:`QuantConv2d`, then its
    BatchNorm (eval mode) and activation."""

    def __init__(self, base: nn.Module, s_x: float):
        super().__init__()
        self.conv = QuantConv2d(base.conv, s_x, base.dtype, base.phase_conv)
        self.bn = base.bn
        self.act = base.act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


def quantized_keys(model: nn.Module, act_scales: Mapping[str, float],
                   min_channels: int = 64) -> list:
    """The scale keys of the convs :func:`quantize_model` computes in int8:
    each eligible conv with a positive scale."""
    return [key for key, m in conv_sites(model).items()
            if act_scales.get(key, 0.0) > 0.0 and eligible(m, min_channels)]


def quantize_model(model: nn.Module, act_scales: Mapping[str, float],
                   min_channels: int = 64) -> nn.Module:
    """A copy of ``model`` in eval mode with each eligible conv that has a
    positive scale in ``act_scales`` computed in int8; the rest keep their
    fp path.  The copy shares nothing the original writes."""
    _check_dtype(model)
    _check_reachable(model, min_channels)
    from .blocks import BaseConv

    qmodel = copy.deepcopy(model).eval()
    sites = conv_sites(qmodel)
    for key in quantized_keys(qmodel, act_scales, min_channels):
        m, s_x = sites[key], act_scales[key]
        name = key[:-len(".conv")] if isinstance(m, BaseConv) else key
        q = (QuantBaseConv(m, s_x) if isinstance(m, BaseConv)
             else QuantConv2d(m, s_x, torch.float32))
        parent_name, _, child = name.rpartition(".")
        setattr(qmodel.get_submodule(parent_name), child, q)
    return qmodel
