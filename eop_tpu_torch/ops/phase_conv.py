"""Small-channel NHWC convolution: the Hopper kernels and their plain version.

Counterpart of ``eop_tpu/ops/pallas/conv_small_c.py`` (the repository's one
TPU kernel).  ``phase_conv(x_nhwc, w_hwio, stride, padding)`` has the JAX
signature and support predicate and computes ``lax.conv_general_dilated``
with symmetric padding; ``scale``, ``shift`` and ``act`` append a per-channel
affine (an eval-mode BatchNorm, folded) and SiLU, which XLA fuses on the JAX
side and the kernels apply in their epilogue:

* a CUDA tensor goes to a hand-written kernel or raises.  The variant is
  chosen from shape and type alone (:func:`kernel_variant`):
  ``wgmma_taps`` (``csrc/phase_conv.cu``: TMA ring, tensor cores, 1x1 and 3x3
  convs on multiples of 32 channels), ``wgmma_rows`` (same file: the 6x6/s2
  stem on 3 channels) or ``direct`` (``csrc/phase_conv_direct.cu``: CUDA
  cores, any shape the predicate admits).  ``phase_conv.last_variant`` names
  the one that ran last;
* a CPU tensor goes to :func:`phase_conv_reference`, which reproduces the
  JAX re-expression step by step — space-to-depth, the scattered phase
  kernel, then a stride-1 convolution — so the CPU tests hold the port's
  phase math to JAX's.

The kernels do not use the phase form as a copy: on the card, stride and
padding are the tensor map's (or index) arithmetic.

With autograd on, ``phase_conv`` goes through :class:`PhaseConvFunction`,
whose backward launches hand-written kernels too (JAX differentiates
``lax.conv_general_dilated`` there and XLA supplies the gradients):
:func:`phase_conv_wgrad` and :func:`phase_conv_dgrad`, on the tensor cores
(``csrc/phase_conv_backward_tc.cu``: the weight gradient split over pixel
chunks, then an ordered reduction, so the result is the same bits on every
run; the stride-2 data gradient by parity class; at stride 1 the forward
kernel on the flipped weights, packed by one kernel launch) where
:func:`wgrad_variant` / :func:`dgrad_variant` take the shape, else on the
CUDA cores (``csrc/phase_conv_backward.cu``, variant ``cuda_cores``).  The
layouts (K order, per-class taps, M tiles, split plan) are decided here, on
the host.  Each has its plain version, :func:`phase_conv_wgrad_reference`
and :func:`phase_conv_dgrad_reference`, which CPU tensors take.

fp32 data runs on the TF32 tensor cores at fp32 accuracy by the split
``a = hi + lo`` (:func:`split_tf32`): three products into fp32 accumulators.
Weights are split and laid out K-major once per weight tensor and cached
(:func:`packed_weights`); activations are split in the kernel.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Optional, Tuple

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


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x = hi + lo`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``: both
    fp32 tensors whose low 13 mantissa bits are clear (TF32 keeps 10), rounded
    to nearest with ties away from zero like ``cvt.rna.tf32.f32``."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


# K order of one run of 32 floats in the packed fp32 weights: position q holds
# the run's logical index K_ORDER[variant][q].  A wgmma K step j reads
# positions 8j .. 8j + 7; thread t of a quad feeds positions 8j + t and
# 8j + t + 4 from its A registers.  wgmma_taps: thread t loads floats
# 8t .. 8t + 7 of the run (two 16-byte loads) and feeds floats 2j, 2j + 1 of
# them to step j.  wgmma_rows: thread t loads floats 8j + 2t, 8j + 2t + 1
# (one 8-byte load) for step j; its runs are consecutive 32s of the flat K.
K_ORDER = {
    "wgmma_taps": [8 * (q % 4) + 2 * j + q // 4
                   for j in range(4) for q in range(8)],
    "wgmma_rows": [8 * j + 2 * (q % 4) + q // 4
                   for j in range(4) for q in range(8)],
}


def _pack_taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[k, k, C, Co]`` -> per (tap, run of channels) K-major tiles.
    fp32: ``[k*k, C/32, 2 (hi, lo), Co, 32]``, K permuted by ``K_ORDER``;
    bf16: ``[k*k, C/run, Co, run]`` with run 64 when C allows, else 32."""
    taps, c, co = w.shape[0] * w.shape[1], w.shape[2], w.shape[3]
    if w.dtype == torch.float32:
        both = torch.stack(split_tf32(w)).reshape(2, taps, c // 32, 32, co)
        both = both[:, :, :, K_ORDER["wgmma_taps"], :]
        return both.permute(1, 2, 0, 4, 3).contiguous()
    run = 64 if c % 64 == 0 else 32
    return w.reshape(taps, c // run, run, co).permute(0, 1, 3, 2).contiguous()


def _pack_rows(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[6, 6, 3, 32]`` -> K-major runs over the flat K index
    ``18 ky + 3 kx + c`` (within one ky, the order an NHWC row has), 108
    values zero-padded to 128.  fp32: ``[4, 2 (hi, lo), Co, 32]``, each run K
    permuted by ``K_ORDER``; bf16: ``[2, Co, 64]``."""
    k, _, c, co = w.shape
    flat = w.new_zeros((128, co))
    flat[: k * k * c] = w.reshape(k * k * c, co)
    if w.dtype != torch.float32:
        return flat.reshape(2, 64, co).permute(0, 2, 1).contiguous()
    both = torch.stack(split_tf32(flat)).reshape(2, 4, 32, co)
    both = both[:, :, K_ORDER["wgmma_rows"], :]
    return both.permute(1, 0, 3, 2).contiguous()


def kernel_variant(x_shape, w_shape, stride: int, padding: int,
                   dtype: torch.dtype) -> str:
    """Which hand-written kernel a CUDA tensor of this shape and type takes."""
    _, _, wd, c = x_shape
    k, _, _, co = w_shape
    if k in (1, 3) and c % 32 == 0 and co in (32, 64, 128):
        return "wgmma_taps"
    row_bytes = wd * c * (4 if dtype == torch.float32 else 2)
    if ((k, stride, padding, c, co) == (6, 2, 2, 3, 32)
            and row_bytes % 16 == 0 and wd <= 1024):
        return "wgmma_rows"
    return "direct"


_PACKERS = {"wgmma_taps": _pack_taps, "wgmma_rows": _pack_rows}
# id(w) -> (weak reference to w, its version, packed weights)
_packed: Dict[int, tuple] = {}


def packed_weights(w: torch.Tensor, variant: str) -> torch.Tensor:
    """The tensor-core layout of HWIO ``w``, made once per weight tensor and
    kept while that tensor lives and is not written to in place."""
    version = 0 if w.is_inference() else w._version
    hit = _packed.get(id(w))
    if hit is not None and hit[0]() is w and hit[1] == version:
        return hit[2]
    out = _PACKERS[variant](w)
    packed_weights.packs += 1
    key = id(w)
    _packed[key] = (weakref.ref(w, lambda _: _packed.pop(key, None)),
                    version, out)
    return out


packed_weights.packs = 0  # packings made (cache misses)


def _check_epilogue(co: int, scale, shift, act, device=None) -> None:
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if act not in (None, "silu"):
        raise ValueError(f"act must be None or 'silu', got {act!r}")
    for name, v in (("scale", scale), ("shift", shift)):
        if v is None:
            continue
        if v.dtype != torch.float32 or tuple(v.shape) != (co,):
            raise ValueError(f"{name} must be float32 [{co}], got "
                             f"{v.dtype} {tuple(v.shape)}")
        if device is not None and (v.device != device
                                   or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {device}")


def _compute_type(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def phase_conv_reference(x: torch.Tensor, w: torch.Tensor, stride: int,
                         padding: int, scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None,
                         act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version: the JAX phase re-expression, computed in fp32
    (the kernel's accumulation type; float64 inputs stay float64), then
    ``* scale + shift`` and SiLU where given, and returned in the input
    type."""
    _check_args(x, w, stride, padding)
    _check_epilogue(w.shape[3], scale, shift, act)
    ct = _compute_type(x)
    xf, wf = x.to(ct), w.to(ct)
    k = w.shape[0]
    if stride == 1:
        p = (k - 1) // 2
        pads = (p, p, p, p)
    else:
        _, pt, pb = _phase_geometry(k, padding)
        xf, wf = _space_to_depth(xf), _phase_weights(wf, padding)
        pads = (pt, pb, pt, pb)
    x_nchw = F.pad(xf.permute(0, 3, 1, 2), pads)
    y = F.conv2d(x_nchw, wf.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    if scale is not None:
        y = y * scale + shift
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def phase_conv_wgrad_reference(x: torch.Tensor, dy: torch.Tensor, k: int,
                               stride: int, padding: int) -> torch.Tensor:
    """Plain PyTorch weight gradient, from the definition:
    ``dw[ky,kx,c,co] = sum_{b,ho,wo} x[b, s*ho+ky-p, s*wo+kx-p, c] *
    dy[b,ho,wo,co]`` with out-of-range ``x`` read as zero; computed in fp32
    and returned ``[k, k, C, Co]`` in the input type."""
    b, h, wd, c = x.shape
    _, ho, wo, co = dy.shape
    ct = _compute_type(x)
    # bottom and right may need less than `padding`; more never hurts
    xp = F.pad(x.to(ct), (0, 0, padding, padding + stride, padding,
                          padding + stride))
    g = dy.to(ct).reshape(-1, co)
    dw = x.new_empty((k, k, c, co), dtype=ct)
    for ky in range(k):
        for kx in range(k):
            win = xp[:, ky: ky + stride * ho: stride,
                     kx: kx + stride * wo: stride]
            dw[ky, kx] = win.reshape(-1, c).t() @ g
    return dw.to(x.dtype)


def phase_conv_dgrad_reference(dy: torch.Tensor, w: torch.Tensor, x_shape,
                               stride: int, padding: int) -> torch.Tensor:
    """Plain PyTorch data gradient, from the definition: every tap scatters
    ``dy[b,ho,wo,:] @ w[ky,kx]^T`` to input pixel ``(s*ho+ky-p, s*wo+kx-p)``;
    computed in fp32 and returned ``x_shape`` in the input type."""
    b, h, wd, c = x_shape
    k = w.shape[0]
    _, ho, wo, co = dy.shape
    ct = _compute_type(dy)
    g, wf = dy.to(ct), w.to(ct)
    dxp = dy.new_zeros((b, h + 2 * padding + stride, wd + 2 * padding + stride,
                        c), dtype=ct)
    for ky in range(k):
        for kx in range(k):
            dxp[:, ky: ky + stride * ho: stride,
                kx: kx + stride * wo: stride] += g @ wf[ky, kx].t()
    return dxp[:, padding: padding + h, padding: padding + wd].to(dy.dtype)


def flipped_weights(w: torch.Tensor) -> torch.Tensor:
    """``w'[ky,kx,co,c] = w[k-1-ky, k-1-kx, c, co]``: the stride-1 data
    gradient is ``phase_conv(dy, w', 1, padding)``."""
    return w.flip(0, 1).permute(0, 1, 3, 2).contiguous()


def flip_taps(k: int):
    """HWIO tap ``ky * k + kx`` of each tap of the flipped weights."""
    return [k * k - 1 - j for j in range(k * k)]


def pack_taps_reference(w: torch.Tensor, src_taps) -> torch.Tensor:
    """Plain version of the packing kernel: the ``_pack_taps`` layout of the
    weights ``[len(src_taps), 1, Co, C]`` whose tap ``j`` is
    ``w[src_taps[j]]`` with its last two axes exchanged.  Then
    ``pack_taps_reference(w, flip_taps(k)) == _pack_taps(flipped_weights(w))``,
    and with a parity class's taps it is what the stride-2 data gradient's
    kernel reads."""
    k, _, c, co = w.shape
    taps = w.reshape(k * k, c, co)[list(src_taps)]
    return _pack_taps(taps.transpose(1, 2).reshape(len(src_taps), 1, co, c))


def pack_taps(w: torch.Tensor, src_taps) -> torch.Tensor:
    """:func:`pack_taps_reference` in one kernel launch for a CUDA ``w``
    (``phase_conv.pack_launches`` counts them), the plain version for a CPU
    one."""
    if w.device.type == "cpu":
        return pack_taps_reference(w, src_taps)
    k, _, c, co = w.shape
    n = len(src_taps)
    if w.dtype == torch.float32:
        run, shape = 32, (n, co // 32, 2, c, 32)
    else:
        run = 64 if co % 64 == 0 else 32
        shape = (n, co // run, c, run)
    if co % 32 or not 0 < n <= 64 or not w.is_contiguous():
        raise ValueError(f"pack_taps: contiguous w with Co a multiple of 32 "
                         f"and 1..64 taps, got {tuple(w.shape)}, {n} taps")
    out = torch.empty(shape, dtype=w.dtype, device=w.device)
    src = (ctypes.c_int * n)(*src_taps)
    perm = (ctypes.c_int * 32)(*K_ORDER["wgmma_taps"])
    with torch.cuda.device(w.device):
        err = _kernel("pack_taps")(
            _DTYPE_CODES[w.dtype], w.data_ptr(), out.data_ptr(), src, n, c, co,
            run, perm, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"phase_conv_pack_taps launch failed: error {err}")
    phase_conv.pack_launches += 1
    return out


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SHAPE_ARGS = [ctypes.c_int] * 10  # B, H, W, C, Co, k, stride, pad, Ho, Wo
_EPILOGUE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
_INTS = ctypes.POINTER(ctypes.c_int)
# C function of each kernel: (library, symbol, argument types)
_SYMBOLS = {
    "wgmma_taps": ("phase_conv", "phase_conv_taps",
                   [ctypes.c_int] + [ctypes.c_void_p] * 3 + _EPILOGUE_ARGS
                   + _SHAPE_ARGS + [ctypes.c_void_p]),
    "wgmma_rows": ("phase_conv", "phase_conv_rows",
                   [ctypes.c_int] + [ctypes.c_void_p] * 3 + _EPILOGUE_ARGS
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "direct": ("phase_conv_direct", "phase_conv_direct",
               [ctypes.c_int] + [ctypes.c_void_p] * 3 + _EPILOGUE_ARGS
               + _SHAPE_ARGS + [ctypes.c_void_p]),
    "wgrad": ("phase_conv_backward", "phase_conv_wgrad",
              [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
              + _SHAPE_ARGS + [ctypes.c_void_p]),
    "wgrad_splits": ("phase_conv_backward", "phase_conv_wgrad_splits",
                     [ctypes.c_int] * 5),
    "dgrad": ("phase_conv_backward", "phase_conv_dgrad",
              [ctypes.c_int] + [ctypes.c_void_p] * 3 + _SHAPE_ARGS
              + [ctypes.c_void_p]),
    "wgrad_tc": ("phase_conv_backward_tc", "phase_conv_wgrad_tc",
                 [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                 + _SHAPE_ARGS + [ctypes.c_void_p]),
    "dgrad_tc": ("phase_conv_backward_tc", "phase_conv_dgrad_tc",
                 [ctypes.c_int] + [ctypes.c_void_p] * 3 + [_INTS, _INTS]
                 + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "pack_taps": ("phase_conv_backward_tc", "phase_conv_pack_taps",
                  [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, _INTS]
                  + [ctypes.c_int] * 4 + [_INTS, ctypes.c_void_p]),
}
_fns: Dict[str, object] = {}


def _kernel(variant: str):
    fn = _fns.get(variant)
    if fn is None:
        from .. import _build

        lib, symbol, argtypes = _SYMBOLS[variant]
        fn = getattr(_build.load(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[variant] = fn
    return fn


def _check_cuda_pair(a: torch.Tensor, b: torch.Tensor, names: str) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{names} must share one CUDA device, got "
                         f"{a.device} and {b.device}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"float32 or bfloat16 {names} of one dtype, got "
                         f"{a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{names} must be contiguous (NHWC, HWIO)")


def _check_aligned(*tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("tensors must be 16-byte aligned for the bulk copies")


def _launch_forward(x, w, stride, padding, scale, shift, act, packed=None):
    """Launch the forward kernel for checked CUDA arguments, on ``packed``
    tensor-core weights where given (``w`` then only lends its shape);
    returns (y, variant)."""
    b, h, wd, c = x.shape
    k, co = w.shape[0], w.shape[3]
    ho, wo = out_hw(h, wd, k, stride, padding)
    y = torch.empty((b, ho, wo, co), dtype=x.dtype, device=x.device)
    variant = kernel_variant(x.shape, w.shape, stride, padding, x.dtype)
    if y.numel() == 0:
        return y, variant
    if variant != "direct":
        _check_aligned(x)
    epilogue = (scale.data_ptr() if scale is not None else None,
                shift.data_ptr() if shift is not None else None,
                1 if act == "silu" else 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if packed is not None:
            wp = packed
        else:
            wp = w if variant == "direct" else packed_weights(w, variant)
        shape = ((b, h, wd, ho, wo) if variant == "wgmma_rows" else
                 (b, h, wd, c, co, k, stride, padding, ho, wo))
        err = _kernel(variant)(_DTYPE_CODES[x.dtype], x.data_ptr(),
                               wp.data_ptr(), y.data_ptr(), *epilogue, *shape,
                               stream)
    if err != 0:
        raise RuntimeError(f"phase_conv kernel ({variant}) launch failed: "
                           f"error {err}")
    return y, variant


WGRAD_CHUNK = 32  # output pixels of one chunk of the tensor-core weight gradient


def wgrad_tiles(x_shape, co: int, k: int, stride: int,
                dtype: torch.dtype) -> Optional[Tuple[int, int, bool]]:
    """M tiling of the tensor-core weight gradient, ``(nky, warpgroups,
    flat)``: an M tile holds the dw rows of ``nky`` whole ky values (k * C
    rows each, 64 per warpgroup); ``flat`` stages x as flat row segments (C
    no multiple of 32).  None where the kernel does not take the shape."""
    _, _, wd, c = x_shape
    es = 4 if dtype == torch.float32 else 2
    if co not in (32, 64, 128):
        return None
    if c % 32 == 0:
        return (1, -(-k * c // 64), False) if k * c <= 192 else None
    # a staged row segment: the chunk's input pixels from the 16-byte
    # boundary before the first, at most 256 elements (one bulk copy box)
    span = stride * (WGRAD_CHUNK - 1) + k
    box = -(-span * c // (16 // es)) * (16 // es) + 16 // es
    if (co == 32 and k * k * c <= 128 and box <= 256
            and wd * c * es % 16 == 0):
        return k, -(-k * k * c // 64), True
    return None


def wgrad_variant(x_shape, co: int, k: int, stride: int,
                  dtype: torch.dtype) -> str:
    """Which kernel the weight gradient of a CUDA tensor takes: ``wgmma``
    (tensor cores) where :func:`wgrad_tiles` takes the shape, else
    ``cuda_cores``."""
    tiles = wgrad_tiles(x_shape, co, k, stride, dtype)
    return "wgmma" if tiles is not None else "cuda_cores"


def wgrad_split_plan(chunks: int, mtiles: int, sms: int,
                     warpgroups: int) -> Tuple[int, int]:
    """``(splits, chunks_per_split)``: split ``i`` of an M tile sums chunks
    ``i * chunks_per_split`` up to the next split's first (the last one to
    ``chunks``); in all about as many blocks as the card holds at once,
    ``4 // warpgroups`` a multiprocessor."""
    target = sms * max(1, 4 // warpgroups)
    splits = max(1, min(chunks, -(-target // mtiles)))
    per = -(-chunks // splits)
    return -(-chunks // per), per


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def phase_conv_wgrad(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int,
                     padding: int, _cuda_cores: bool = False) -> torch.Tensor:
    """Weight gradient ``[k, k, C, Co]`` of ``phase_conv`` for input ``x``
    ``[B, H, W, C]`` and output gradient ``dy`` ``[B, Ho, Wo, Co]``.  A CPU
    pair takes the plain version; a CUDA pair launches the kernels of
    :func:`wgrad_variant` or raises (``_cuda_cores`` forces the CUDA-core
    kernels, for comparisons).  Deterministic: two calls on one
    input give the same bits.  ``phase_conv.wgrad_launches`` counts the calls,
    ``phase_conv.last_wgrad_variant`` names the kernel."""
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return phase_conv_wgrad_reference(x, dy, k, stride, padding)
    _check_cuda_pair(x, dy, "x and dy")
    b, h, wd, c = x.shape
    co = dy.shape[3]
    if not supported(k, stride, padding):
        raise ValueError(f"unsupported conv: k={k} stride={stride} "
                         f"padding={padding}")
    ho, wo = out_hw(h, wd, k, stride, padding)
    if tuple(dy.shape) != (b, ho, wo, co):
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of x "
                         f"{tuple(x.shape)}: expected {(b, ho, wo, co)}")
    variant = ("cuda_cores" if _cuda_cores else
               wgrad_variant(x.shape, co, k, stride, x.dtype))
    dw = torch.empty((k, k, c, co), dtype=x.dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    if dy.numel() == 0:
        return dw.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "wgmma":
            nky, wgs, flat = wgrad_tiles(x.shape, co, k, stride, x.dtype)
            _check_aligned(x, dy)
            chunks = b * ho * -(-wo // WGRAD_CHUNK)
            splits, per = wgrad_split_plan(chunks, k // nky,
                                           _sm_count(x.device), wgs)
            part = torch.empty((splits, dw.numel()), dtype=torch.float32,
                               device=x.device)
            err = _kernel("wgrad_tc")(
                _DTYPE_CODES[x.dtype], x.data_ptr(), dy.data_ptr(),
                dw.data_ptr(), part.data_ptr(), splits, per, nky, wgs,
                int(flat), b, h, wd, c, co, k, stride, padding, ho, wo, stream)
        else:
            splits = _kernel("wgrad_splits")(c, co, k, b * ho,
                                             _sm_count(x.device))
            part = torch.empty((splits, dw.numel()), dtype=torch.float32,
                               device=x.device)
            err = _kernel("wgrad")(
                _DTYPE_CODES[x.dtype], x.data_ptr(), dy.data_ptr(),
                dw.data_ptr(), part.data_ptr(), splits, b, h, wd, c, co, k,
                stride, padding, ho, wo, stream)
    if err != 0:
        raise RuntimeError(f"phase_conv_wgrad ({variant}) launch failed: "
                           f"error {err}")
    phase_conv.wgrad_launches += 1
    phase_conv.last_wgrad_variant = variant
    return dw


def dgrad_class_plan(k: int, padding: int):
    """The stride-2 data gradient by parity class: ``[(ph, pw, taps), ...]``
    with ``taps = [(ky, kx, oy, ox), ...]``, the taps reaching input pixels
    ``(2 h2 + ph, 2 w2 + pw)`` and the output pixel ``(h2 + oy, w2 + ox)``
    each reads; classes with most taps first (the kernel's tile order), taps
    in HWIO order (their packed order)."""
    classes = []
    for ph in (0, 1):
        for pw in (0, 1):
            taps = [(ky, kx, (ph + padding - ky) // 2, (pw + padding - kx) // 2)
                    for ky in range(k) if (ph + padding - ky) % 2 == 0
                    for kx in range(k) if (pw + padding - kx) % 2 == 0]
            classes.append((ph, pw, taps))
    return sorted(classes, key=lambda cl: -len(cl[2]))


def dgrad_variant(dy_shape, w_shape, stride: int, padding: int,
                  dtype: torch.dtype) -> str:
    """Which kernel the data gradient of a CUDA tensor takes: at stride 1 the
    forward kernel on the flipped weights (``"flipped:<variant>"``) where a
    tensor-core variant takes that shape; at stride 2 ``"wgmma_classes"``
    (1x1 and 3x3, C in 32, 64, 128, Co a multiple of 32); else
    ``"cuda_cores"``."""
    k, _, c, co = w_shape
    if stride == 1:
        fwd = kernel_variant(dy_shape, (k, k, co, c), 1, padding, dtype)
        if fwd != "direct":
            return f"flipped:{fwd}"
    elif k in (1, 3) and co % 32 == 0 and c in (32, 64, 128):
        return "wgmma_classes"
    return "cuda_cores"


def phase_conv_dgrad(dy: torch.Tensor, w: torch.Tensor, x_shape, stride: int,
                     padding: int, _cuda_cores: bool = False) -> torch.Tensor:
    """Data gradient ``x_shape`` of ``phase_conv`` for HWIO ``w`` and output
    gradient ``dy`` ``[B, Ho, Wo, Co]``.  A CPU pair takes the plain version;
    a CUDA pair launches the kernels of :func:`dgrad_variant` or raises
    (``_cuda_cores`` forces the CUDA-core kernel, for comparisons).  The tensor-core variants first pack the weights in one
    launch (:func:`pack_taps`).  ``phase_conv.dgrad_launches`` counts the
    calls, ``phase_conv.last_dgrad_variant`` names the kernel."""
    if dy.device.type == "cpu" and w.device.type == "cpu":
        return phase_conv_dgrad_reference(dy, w, x_shape, stride, padding)
    _check_cuda_pair(dy, w, "dy and w")
    x_shape = tuple(int(v) for v in x_shape)
    b, h, wd, c = x_shape
    k, co = w.shape[0], w.shape[3]
    ho, wo = out_hw(h, wd, k, stride, padding)
    if not supported(k, stride, padding) or (
            stride == 2 and (h % 2 or wd % 2)):
        raise ValueError(f"unsupported conv: k={k} stride={stride} "
                         f"padding={padding} on {x_shape}")
    if tuple(dy.shape) != (b, ho, wo, co):
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of "
                         f"{x_shape}: expected {(b, ho, wo, co)}")
    variant = ("cuda_cores" if _cuda_cores else
               dgrad_variant(dy.shape, w.shape, stride, padding, dy.dtype))
    if variant.startswith("flipped:"):
        wp = pack_taps(w, flip_taps(k))
        dx, _ = _launch_forward(dy, w.new_empty((k, k, co, c), device="meta"),
                                1, padding, None, None, None, packed=wp)
    else:
        dx = torch.empty(x_shape, dtype=dy.dtype, device=dy.device)
        if dx.numel() == 0:
            return dx
        if dy.numel() == 0:
            return dx.zero_()
        with torch.cuda.device(dy.device):
            stream = torch.cuda.current_stream().cuda_stream
            if variant == "wgmma_classes":
                _check_aligned(dy)
                plan = dgrad_class_plan(k, padding)
                taps = [t for _, _, ts in plan for t in ts]
                wp = pack_taps(w, [ky * k + kx for ky, kx, _, _ in taps])
                table, first = [], 0
                for ph, pw, ts in plan:
                    table += [len(ts), first, ph, pw]
                    first += len(ts)
                offsets = [v for _, _, oy, ox in taps for v in (oy, ox)]
                err = _kernel("dgrad_tc")(
                    _DTYPE_CODES[dy.dtype], dy.data_ptr(), wp.data_ptr(),
                    dx.data_ptr(), (ctypes.c_int * 16)(*table),
                    (ctypes.c_int * len(offsets))(*offsets), len(taps), b, h,
                    wd, c, co, ho, wo, stream)
            else:
                wt = w.permute(0, 1, 3, 2).contiguous()  # [k, k, Co, C]
                err = _kernel("dgrad")(
                    _DTYPE_CODES[dy.dtype], dy.data_ptr(), wt.data_ptr(),
                    dx.data_ptr(), b, h, wd, c, co, k, stride, padding, ho,
                    wo, stream)
        if err != 0:
            raise RuntimeError(f"phase_conv_dgrad ({variant}) launch failed: "
                               f"error {err}")
    phase_conv.dgrad_launches += 1
    phase_conv.last_dgrad_variant = variant
    return dx


class PhaseConvFunction(torch.autograd.Function):
    """``phase_conv`` without epilogue, differentiable: forward launches the
    forward kernel, backward :func:`phase_conv_dgrad` (where ``x`` takes a
    gradient) and :func:`phase_conv_wgrad` (where ``w`` does).  CPU tensors
    run the plain versions of all three."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding)
        if x.device.type == "cpu":
            return phase_conv_reference(x, w, stride, padding)
        y, variant = _launch_forward(x, w, stride, padding, None, None, None)
        if y.numel():
            phase_conv.launches += 1
            phase_conv.last_variant = variant
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conv
        if not dy.is_contiguous():
            dy = dy.contiguous()
            phase_conv.dy_copies += 1
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = phase_conv_dgrad(dy, w, x.shape, stride, padding)
        if ctx.needs_input_grad[1]:
            dw = phase_conv_wgrad(x, dy, w.shape[0], stride, padding)
        return dx, dw, None, None


def phase_conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None,
               act: Optional[str] = None) -> torch.Tensor:
    """NHWC x HWIO conv with symmetric ``padding``; semantics of
    ``lax.conv_general_dilated`` (and of the JAX ``phase_conv``), then
    ``* scale + shift`` (fp32 ``[Co]``) and ``act`` (``"silu"``) where given.

    Supported: stride 1 with odd k and p=(k-1)//2; stride 2 with odd k and
    p=(k-1)//2 or even k and p=k/2-1, on even H and W.  Anything else
    raises.  Differentiable in ``x`` and ``w`` without the epilogue
    (:class:`PhaseConvFunction`); with it, a CUDA call under autograd raises.

    Counters: ``phase_conv.launches`` (forward; ``.fused_launches`` of them
    with the epilogue), ``.wgrad_launches``,
    ``.dgrad_launches``, ``.pack_launches`` (the data gradients' weight
    packing), ``.dy_copies`` (output gradients that arrived non-contiguous
    and were copied to NHWC); ``.last_variant``, ``.last_wgrad_variant`` and
    ``.last_dgrad_variant`` name the kernels of the last launches.
    """
    cpu = x.device.type == "cpu" and w.device.type == "cpu"
    wants_grad = torch.is_grad_enabled() and (x.requires_grad
                                              or w.requires_grad)
    no_epilogue = scale is None and shift is None and act is None
    if cpu and not (wants_grad and no_epilogue):
        return phase_conv_reference(x, w, stride, padding, scale, shift, act)
    _check_args(x, w, stride, padding)
    if not cpu:
        _check_cuda_pair(x, w, "x and w")
    if wants_grad:
        if not no_epilogue:
            raise NotImplementedError(
                "the fused scale, shift and act have no backward kernel: "
                "under autograd call phase_conv without them and apply "
                "BatchNorm and SiLU as modules")
        return PhaseConvFunction.apply(x, w, stride, padding)
    _check_epilogue(w.shape[3], scale, shift, act, x.device)
    y, variant = _launch_forward(x, w, stride, padding, scale, shift, act)
    if y.numel():
        phase_conv.launches += 1
        phase_conv.fused_launches += scale is not None
        phase_conv.last_variant = variant
    return y


phase_conv.launches = 0
phase_conv.fused_launches = 0
phase_conv.wgrad_launches = 0
phase_conv.dgrad_launches = 0
phase_conv.dy_copies = 0
phase_conv.pack_launches = 0
phase_conv.last_variant = None
phase_conv.last_wgrad_variant = None
phase_conv.last_dgrad_variant = None
