"""Small-channel NHWC convolution: the Hopper kernel and its plain version.

Counterpart of ``eop_tpu/ops/pallas/conv_small_c.py`` (the repository's one
TPU kernel).  ``phase_conv(x_nhwc, w_hwio, stride, padding)`` has the JAX
signature and support predicate and computes ``lax.conv_general_dilated``
with symmetric padding:

* a CUDA tensor goes to the hand-written kernel (``csrc/phase_conv.cu``, a
  direct implicit-GEMM conv over contiguous NHWC) or raises;
* a CPU tensor goes to :func:`phase_conv_reference`, which reproduces the
  JAX re-expression step by step — space-to-depth, the scattered phase
  kernel, then a stride-1 convolution — so the CPU tests hold the port's
  phase math to JAX's.

The kernel does not use the phase form: on the card, stride and padding are
index arithmetic, so it needs no padded or space-to-depth copy.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F


def _phase_geometry(k: int, padding: int) -> Tuple[int, int, int]:
    """Stride-2 kxk conv -> stride-1 phase conv geometry: (extent k2,
    pad_top, pad_bottom) in phase-grid rows; the same for columns."""
    lo = (-padding) // 2
    hi = (k - 1 - padding) // 2
    return hi - lo + 1, -lo, hi


def _phase_weights(w: torch.Tensor, padding: int) -> torch.Tensor:
    """Scatter HWIO weights [k, k, C, Co] into the phase kernel
    [k2, k2, 4C, Co]; phase channel order matches `_space_to_depth`."""
    k, _, c, co = w.shape
    k2, _, _ = _phase_geometry(k, padding)
    lo = (-padding) // 2
    w2 = w.new_zeros((k2, k2, 4 * c, co))
    for ky in range(k):
        dy, py = (ky - padding) // 2 - lo, (ky - padding) % 2
        for kx in range(k):
            dx, px = (kx - padding) // 2 - lo, (kx - padding) % 2
            ch = (py * 2 + px) * c
            w2[dy, dx, ch: ch + c] = w[ky, kx]
    return w2


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, H/2, W/2, 4C]; phase-major channels."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def supported(k: int, stride: int, padding: int) -> bool:
    """The JAX kernel's support predicate (`conv_small_c.py::_supported`)."""
    if stride == 1:
        return padding == (k - 1) // 2
    if stride == 2:
        return padding == (k - 1) // 2 or (k % 2 == 0 and padding == k // 2 - 1)
    return False


def _check_args(x: torch.Tensor, w: torch.Tensor, stride: int,
                padding: int) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected x [B,H,W,C] and w [k,k,C,Co], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    k = w.shape[0]
    if w.shape[1] != k:
        raise ValueError(f"square kernels only, got {tuple(w.shape)}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"input channels {x.shape[3]} != kernel's {w.shape[2]}")
    if not supported(k, stride, padding):
        raise ValueError(f"unsupported conv: k={k} stride={stride} "
                         f"padding={padding}")
    if stride == 2 and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"stride 2 needs even H and W, got {tuple(x.shape)}")


def out_hw(h: int, w: int, k: int, stride: int, padding: int):
    return ((h + 2 * padding - k) // stride + 1,
            (w + 2 * padding - k) // stride + 1)


def phase_conv_reference(x: torch.Tensor, w: torch.Tensor, stride: int,
                         padding: int) -> torch.Tensor:
    """Plain PyTorch version: the JAX phase re-expression, computed in fp32
    (the kernel's accumulation type) and returned in the input type."""
    _check_args(x, w, stride, padding)
    xf, wf = x.float(), w.float()
    k = w.shape[0]
    if stride == 1:
        p = (k - 1) // 2
        pads = (p, p, p, p)
    else:
        _, pt, pb = _phase_geometry(k, padding)
        xf, wf = _space_to_depth(xf), _phase_weights(wf, padding)
        pads = (pt, pb, pt, pb)
    x_nchw = F.pad(xf.permute(0, 3, 1, 2), pads)
    y = F.conv2d(x_nchw, wf.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).to(x.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from .. import _build

        fn = _build.load("phase_conv").phase_conv_nhwc
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def phase_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: int) -> torch.Tensor:
    """NHWC x HWIO conv with symmetric ``padding``; semantics of
    ``lax.conv_general_dilated`` (and of the JAX ``phase_conv``).

    Supported: stride 1 with odd k and p=(k-1)//2; stride 2 with odd k and
    p=(k-1)//2 or even k and p=k/2-1, on even H and W.  Anything else
    raises.  ``phase_conv.launches`` counts kernel launches.
    """
    if x.device.type == "cpu" and w.device.type == "cpu":
        return phase_conv_reference(x, w, stride, padding)
    _check_args(x, w, stride, padding)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x and w must share one CUDA device, got "
                         f"{x.device} and {w.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"float32 or bfloat16 x and w of one dtype, got "
                         f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x (NHWC) and w (HWIO) must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError("phase_conv has no backward kernel yet")
    b, h, wd, c = x.shape
    k, co = w.shape[0], w.shape[3]
    ho, wo = out_hw(h, wd, k, stride, padding)
    y = torch.empty((b, ho, wo, co), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                        y.data_ptr(), b, h, wd, c, co, k, stride, padding,
                        ho, wo, stream)
    if err != 0:
        raise RuntimeError(f"phase_conv kernel launch failed: CUDA error {err}")
    phase_conv.launches += 1
    return y


phase_conv.launches = 0
