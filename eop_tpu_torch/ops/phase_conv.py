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
  convs with C and Co multiples of 8: channel runs zero-filled past C, Co in
  N tiles of at most 128, :func:`taps_run`, :func:`co_tiles`), ``wgmma_rows``
  (same file: the 6x6/s2 and 3x3/s1 stems on 3 channels, Co in N tiles of
  :func:`rows_tile`), ``small_1x1`` (``csrc/phase_conv_1x1.cu``: CUDA cores,
  the 1x1 stride-1 convs of :data:`SMALL_1X1` size, a bulk-copy ring) or
  ``direct`` (``csrc/phase_conv_direct.cu``: CUDA cores, any shape the
  predicate admits; no conv of the port's models takes it).
  ``phase_conv.last_variant`` names the one that ran last;
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
kernel on the flipped weights, packed by one kernel launch; the small 1x1
convs' on ``small_1x1`` with the weights read transposed) where
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


def taps_run(c: int, dtype: torch.dtype) -> int:
    """Channels of one K run of ``wgmma_taps`` (one 128- or 64-byte swizzled
    row): 32 in fp32; in bf16 64 where that pads C no further than runs of 32
    do, else 32.  The last run reads zeros (or, at stride 2, the next phase's
    channels) past C, against zero weights."""
    if dtype == torch.float32:
        return 32
    return 64 if -(-c // 64) * 64 <= -(-c // 32) * 32 else 32


def co_tiles(co: int) -> Tuple[int, int]:
    """``(tile, tiles)``: the tensor-core kernels cut Co into ``tiles`` N tiles
    of ``tile`` channels (32, 64, 96 or 128): as few tiles as a width of 128
    allows, each the multiple of 32 that holds its share; the last tile's
    channels past Co are zero weights (forward) or zero dy (weight gradient)
    and are not stored."""
    n = -(-co // 128)
    return -(-co // (32 * n)) * 32, n


def _pack_taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[k, k, C, Co]`` -> per (tap, run of channels, N tile) K-major
    tiles, zero past C and past Co (:func:`taps_run`, :func:`co_tiles`).
    fp32: ``[k*k, runs, tiles * 2 (tile, hi / lo), tile, 32]``, K permuted by
    ``K_ORDER``; bf16: ``[k*k, runs, tiles * tile, run]``."""
    taps, c, co = w.shape[0] * w.shape[1], w.shape[2], w.shape[3]
    run = taps_run(c, w.dtype)
    tile, nt = co_tiles(co)
    runs = -(-c // run)
    wp = w.new_zeros((taps, runs * run, nt * tile))
    wp[:, :c, :co] = w.reshape(taps, c, co)
    wp = wp.reshape(taps, runs, run, nt, tile)
    if w.dtype == torch.float32:
        both = torch.stack(split_tf32(wp))[:, :, :, K_ORDER["wgmma_taps"]]
        return both.permute(1, 2, 4, 0, 5, 3).reshape(
            taps, runs, nt * 2, tile, run).contiguous()
    return wp.permute(0, 1, 3, 4, 2).reshape(taps, runs, nt * tile,
                                             run).contiguous()


def _rows_runs(k: int, c: int, dtype: torch.dtype) -> int:
    """128-byte weight runs of ``wgmma_rows`` over the flat K of k * k * c."""
    return -(-k * k * c // (32 if dtype == torch.float32 else 64))


def _pack_rows(w: torch.Tensor, tile: Optional[int] = None) -> torch.Tensor:
    """HWIO ``[k, k, 3, Co]`` (the 6x6 and 3x3 stems) -> per N tile of
    ``tile`` channels (one tile of ``co_tiles(Co)`` by default), K-major
    runs over the flat K index ``3k ky + 3 kx + c`` (within one ky, the order
    an NHWC row has), zero-padded to whole runs and past Co.  fp32:
    ``[tiles * runs, 2 (hi, lo), tile, 32]``, each run K permuted by
    ``K_ORDER``; bf16: ``[tiles * runs, tile, 64]``; tile ``t``'s runs
    first from ``t * runs``."""
    k, _, c, co = w.shape
    tile = tile or co_tiles(co)[0]
    nt = -(-co // tile)
    runs = _rows_runs(k, c, w.dtype)
    per = 32 if w.dtype == torch.float32 else 64
    flat = w.new_zeros((runs * per, nt * tile))
    flat[: k * k * c, :co] = w.reshape(k * k * c, co)
    flat = flat.reshape(runs * per, nt, tile).permute(1, 0, 2)
    if w.dtype != torch.float32:
        return flat.reshape(nt, runs, 64, tile).permute(0, 1, 3, 2).reshape(
            nt * runs, tile, 64).contiguous()
    both = torch.stack(split_tf32(flat)).reshape(2, nt, runs, 32, tile)
    both = both[:, :, :, K_ORDER["wgmma_rows"], :]
    return both.permute(1, 2, 0, 4, 3).reshape(nt * runs, 2, tile,
                                                32).contiguous()


# (k, stride, padding, C) of the stems wgmma_rows takes
ROWS_STEMS = ((6, 2, 2, 3), (3, 1, 1, 3))
# 1x1 stride-1 convs with C * Co at most this (YOLOX-Nano's 16- and
# 32-channel ones, at 104 x 104 for 416 px) take the CUDA-core small_1x1
# kernel, forward and data gradient: bound by bytes, with a quarter of the
# byte time in FMAs, they gain nothing from the tensor cores' packed and
# split products; their weight gradients take the tensor cores
SMALL_1X1 = 512
_SMEM_BLOCK = 227 * 1024  # shared memory a block may use on Hopper


def small_1x1_fits(k: int, stride: int, c: int, co: int) -> bool:
    """Whether ``small_1x1`` takes a conv from C to Co channels (or its data
    gradient, from Co to C): 1x1 at stride 1, C and Co multiples of 8,
    C * Co at most :data:`SMALL_1X1`."""
    return (k == 1 and stride == 1 and c % 8 == 0 and co % 8 == 0
            and c * co <= SMALL_1X1)


def rows_tile(wd: int, co: int, k: int,
              dtype: torch.dtype) -> Optional[Tuple[int, int]]:
    """``(tile, tiles)``: the N tiles of ``conv_rows_kernel`` for stem rows
    of width ``wd``.  The widest tile of 96, 64 or 32 channels (as few tiles
    as that width allows, each the multiple of 32 that holds its share)
    whose weights leave the block's shared memory, beside a slot of zeros,
    a ring of more than one step's live input rows (its ``launch_rows``, to
    the byte).  None where even 32 leaves no such ring or a row is no
    multiple of 16 bytes."""
    es = 4 if dtype == torch.float32 else 2
    if (wd * 3 * es) % 16:
        return None
    s, nwg = (2 if k == 6 else 1), 4
    live, new = s * (nwg - 1) + k, s * nwg
    slot = es * (8 + 3 * wd + 16)
    for width in (96, 64, 32):
        n = -(-co // width)
        tile = -(-co // (32 * n)) * 32
        wbytes = _rows_runs(k, 3, dtype) * (2 if es == 4 else 1) * tile * 128
        fixed = 1024 + wbytes + 8 + slot
        if min(live + new, (_SMEM_BLOCK - fixed) // (slot + 16)) > live:
            return tile, n
    return None


def kernel_variant(x_shape, w_shape, stride: int, padding: int,
                   dtype: torch.dtype) -> str:
    """Which hand-written kernel a CUDA tensor of this shape and type takes:
    ``small_1x1`` for the 1x1 stride-1 convs of :func:`small_1x1_fits`,
    ``wgmma_taps`` for the other 1x1 and 3x3 convs with C and Co multiples
    of 8, ``wgmma_rows`` for the stems on 3 channels where
    :func:`rows_tile` takes the row width, else ``direct``."""
    _, _, wd, c = x_shape
    k, _, _, co = w_shape
    if co % 8:
        return "direct"
    if small_1x1_fits(k, stride, c, co):
        return "small_1x1"
    if (k == 3 or (k == 1 and c * co > SMALL_1X1)) and c % 8 == 0:
        return "wgmma_taps"
    if ((k, stride, padding, c) in ROWS_STEMS
            and rows_tile(wd, co, k, dtype) is not None):
        return "wgmma_rows"
    return "direct"


# id(w) -> (weak reference to w, its version, (variant, tile), packed weights)
_packed: Dict[int, tuple] = {}


def packed_weights(w: torch.Tensor, variant: str,
                   tile: Optional[int] = None) -> torch.Tensor:
    """The tensor-core layout of HWIO ``w`` for ``variant`` (``wgmma_rows``:
    in N tiles of ``tile`` channels), made once per weight tensor and layout
    and kept while that tensor lives and is not written to in place."""
    version = 0 if w.is_inference() else w._version
    layout = (variant, tile)
    hit = _packed.get(id(w))
    if (hit is not None and hit[0]() is w and hit[1] == version
            and hit[2] == layout):
        return hit[3]
    out = _pack_rows(w, tile) if variant == "wgmma_rows" else _pack_taps(w)
    packed_weights.packs += 1
    key = id(w)
    _packed[key] = (weakref.ref(w, lambda _: _packed.pop(key, None)),
                    version, layout, out)
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


def pack_taps_shape(n: int, c: int, co: int, dtype: torch.dtype):
    """Shape of :func:`pack_taps`' output for ``n`` taps of HWIO ``[k, k, C,
    Co]`` weights: the ``_pack_taps`` layout of a conv from Co to C channels,
    K in runs of ``taps_run(Co)`` and N in the tiles of ``co_tiles(C)``."""
    run = taps_run(co, dtype)
    tile, nt = co_tiles(c)
    runs = -(-co // run)
    if dtype == torch.float32:
        return (n, runs, nt * 2, tile, run)
    return (n, runs, nt * tile, run)


def pack_taps(w: torch.Tensor, src_taps) -> torch.Tensor:
    """:func:`pack_taps_reference` in one kernel launch for a CUDA ``w``
    (``phase_conv.pack_launches`` counts them), the plain version for a CPU
    one.  C and Co are multiples of 8: the K runs past Co and the N tile
    past C are written as zeros."""
    if w.device.type == "cpu":
        return pack_taps_reference(w, src_taps)
    k, _, c, co = w.shape
    n = len(src_taps)
    if c % 8 or co % 8 or not 0 < n <= 64 or not w.is_contiguous():
        raise ValueError(f"pack_taps: contiguous w with C and Co multiples "
                         f"of 8 and 1..64 taps, got {tuple(w.shape)}, {n} "
                         f"taps")
    out = torch.empty(pack_taps_shape(n, c, co, w.dtype), dtype=w.dtype,
                      device=w.device)
    src = (ctypes.c_int * n)(*src_taps)
    perm = (ctypes.c_int * 32)(*K_ORDER["wgmma_taps"])
    with torch.cuda.device(w.device):
        err = _kernel("pack_taps")(
            _DTYPE_CODES[w.dtype], w.data_ptr(), out.data_ptr(), src, n, c, co,
            taps_run(co, w.dtype), co_tiles(c)[0], perm,
            torch.cuda.current_stream().cuda_stream)
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
                   + _SHAPE_ARGS + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    "wgmma_rows": ("phase_conv", "phase_conv_rows",
                   [ctypes.c_int] + [ctypes.c_void_p] * 3 + _EPILOGUE_ARGS
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "direct": ("phase_conv_direct", "phase_conv_direct",
               [ctypes.c_int] + [ctypes.c_void_p] * 3 + _EPILOGUE_ARGS
               + _SHAPE_ARGS + [ctypes.c_void_p]),
    "small_1x1": ("phase_conv_1x1", "phase_conv_small_1x1",
                  [ctypes.c_int] + [ctypes.c_void_p] * 3 + _EPILOGUE_ARGS
                  + [ctypes.c_longlong] + [ctypes.c_int] * 3
                  + [ctypes.c_void_p]),
    "wgrad": ("phase_conv_backward", "phase_conv_wgrad",
              [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
              + _SHAPE_ARGS + [ctypes.c_void_p]),
    "wgrad_splits": ("phase_conv_backward", "phase_conv_wgrad_splits",
                     [ctypes.c_int] * 5),
    "dgrad": ("phase_conv_backward", "phase_conv_dgrad",
              [ctypes.c_int] + [ctypes.c_void_p] * 3 + _SHAPE_ARGS
              + [ctypes.c_void_p]),
    "wgrad_tc": ("phase_conv_backward_tc", "phase_conv_wgrad_tc",
                 [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                 + _SHAPE_ARGS + [ctypes.c_void_p]),
    "dgrad_tc": ("phase_conv_backward_tc", "phase_conv_dgrad_tc",
                 [ctypes.c_int] + [ctypes.c_void_p] * 3 + [_INTS, _INTS]
                 + [ctypes.c_int] * 10 + [ctypes.c_void_p]),
    "pack_taps": ("phase_conv_backward_tc", "phase_conv_pack_taps",
                  [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, _INTS]
                  + [ctypes.c_int] * 5 + [_INTS, ctypes.c_void_p]),
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


def _launch_forward(x, w, stride, padding, scale, shift, act, packed=None,
                    variant=None):
    """Launch the forward kernel for checked CUDA arguments: ``variant``, or
    :func:`kernel_variant`'s where None; on ``packed`` ``wgmma_taps``
    weights where given (``w`` then only lends its shape, and the variant
    must be ``wgmma_taps``); returns (y, variant)."""
    b, h, wd, c = x.shape
    k, co = w.shape[0], w.shape[3]
    ho, wo = out_hw(h, wd, k, stride, padding)
    y = torch.empty((b, ho, wo, co), dtype=x.dtype, device=x.device)
    if variant is None:
        variant = kernel_variant(x.shape, w.shape, stride, padding, x.dtype)
    if packed is not None and variant != "wgmma_taps":
        raise ValueError(f"packed wgmma_taps weights cannot run on {variant}")
    if y.numel() == 0:
        return y, variant
    if variant != "direct":
        _check_aligned(x)
    epilogue = (scale.data_ptr() if scale is not None else None,
                shift.data_ptr() if shift is not None else None,
                1 if act == "silu" else 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "small_1x1":
            err = _small_1x1(x, w, y, False, epilogue, stream)
            if err != 0:
                raise RuntimeError(f"phase_conv kernel (small_1x1) launch "
                                   f"failed: error {err}")
            return y, variant
        tile = (rows_tile(wd, co, k, x.dtype)[0] if variant == "wgmma_rows"
                else None)
        if packed is not None:
            wp = packed
        else:
            wp = w if variant == "direct" else packed_weights(w, variant,
                                                              tile)
        if variant == "wgmma_rows":
            shape = (b, h, wd, ho, wo, k, co, tile)
        else:
            shape = (b, h, wd, c, co, k, stride, padding, ho, wo)
        if variant == "wgmma_taps":
            shape += (taps_run(c, x.dtype), co_tiles(co)[0])
        err = _kernel(variant)(_DTYPE_CODES[x.dtype], x.data_ptr(),
                               wp.data_ptr(), y.data_ptr(), *epilogue, *shape,
                               stream)
    if err != 0:
        raise RuntimeError(f"phase_conv kernel ({variant}) launch failed: "
                           f"error {err}")
    return y, variant


def _small_1x1(x, w, y, transpose_w: bool, epilogue, stream) -> int:
    """Launch ``small_1x1`` on checked CUDA arguments (``y`` fresh, so
    16-byte aligned like ``x``): ``y[M, N] = x[M, K] . W`` over the last
    axes, with the HWIO weights ``[1, 1, C, Co]`` read as ``W = [C, Co]``
    (the forward) or, with ``transpose_w`` (the data gradient: ``x`` is dy,
    ``y`` dx), as the transpose of ``[C, Co]``; then the ``epilogue``
    (scale and shift pointers, act).  Returns the C function's code."""
    k_in, n_out = x.shape[-1], y.shape[-1]
    return _kernel("small_1x1")(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), y.data_ptr(),
        *epilogue, x.numel() // k_in, k_in, n_out, int(transpose_w), stream)


WGRAD_CHUNK = 32  # output pixels of one chunk of the tensor-core weight gradient


def _wgrad_stage_bytes(c: int, co: int, k: int, stride: int, nky: int,
                       flat: bool, es: int) -> int:
    """Shared memory of one ring stage of ``wgrad_tc_kernel`` (its host
    function's arithmetic): the staged x of an M tile, the dy box of an N
    tile and its K-major copy (hi and lo in fp32), each 1024-aligned."""
    tile, _ = co_tiles(co)
    span = stride * (WGRAD_CHUNK - 1) + k
    if flat:
        align = 16 // es
        box = -(-span * c // align) * align + align
        x_bytes = nky * ((box * es + 127) & ~127)
    else:
        x_bytes = nky * -(-c // 32) * ((span + 7) & ~7) * 32 * es

    def up(v):
        return (v + 1023) & ~1023

    b_bytes = (2 if es == 4 else 1) * tile * WGRAD_CHUNK * es
    return up(up(x_bytes) + up(WGRAD_CHUNK * tile * es) + b_bytes)


def wgrad_tiles(x_shape, co: int, k: int, stride: int,
                dtype: torch.dtype) -> Optional[Tuple[int, int, bool]]:
    """M tiling of the tensor-core weight gradient, ``(nky, warpgroups,
    flat)``: an M tile holds the dw rows of ``nky`` whole ky values (k * C
    rows each, 64 per warpgroup), or, where one ky has more than 192 rows, a
    part of 128 of them (:func:`wgrad_mparts`); ``flat`` stages x as flat
    row segments (C no multiple of 8), else runs of 32 channels zero-filled
    past C.  Co (a multiple of 8) goes in the N tiles of :func:`co_tiles`.
    None where the kernel does not take the shape."""
    _, _, wd, c = x_shape
    es = 4 if dtype == torch.float32 else 2
    if co % 8:
        return None
    if c % 8 == 0:
        plan = (1, -(-k * c // 64) if k * c <= 192 else 2, False)
    else:
        # a staged row segment: the chunk's input pixels from the 16-byte
        # boundary before the first, at most 256 elements (one bulk copy box)
        span = stride * (WGRAD_CHUNK - 1) + k
        box = -(-span * c // (16 // es)) * (16 // es) + 16 // es
        if not (k * k * c <= 128 and box <= 256 and wd * c * es % 16 == 0):
            return None
        plan = (k, -(-k * k * c // 64), True)
    # a ring of two stages at the least
    stage = _wgrad_stage_bytes(c, co, k, stride, plan[0], plan[2], es)
    return plan if 1024 + 2 * (stage + 8) <= _SMEM_BLOCK else None


def wgrad_mparts(c: int, k: int, tiles: Tuple[int, int, bool]) -> int:
    """M tiles over one group of ``nky`` ky values: 1 unless a ky's k * C dw
    rows are more than the tile's ``64 * warpgroups``."""
    nky, wgs, _ = tiles
    return -(-nky * k * c // (64 * wgs))


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
            tiles = wgrad_tiles(x.shape, co, k, stride, x.dtype)
            nky, wgs, flat = tiles
            mparts = wgrad_mparts(c, k, tiles)
            tile, ntiles = co_tiles(co)
            _check_aligned(x, dy)
            chunks = b * ho * -(-wo // WGRAD_CHUNK)
            splits, per = wgrad_split_plan(chunks, k // nky * mparts * ntiles,
                                           _sm_count(x.device), wgs)
            part = torch.empty((splits, dw.numel()), dtype=torch.float32,
                               device=x.device)
            err = _kernel("wgrad_tc")(
                _DTYPE_CODES[x.dtype], x.data_ptr(), dy.data_ptr(),
                dw.data_ptr(), part.data_ptr(), splits, per, nky, wgs,
                int(flat), mparts, tile, b, h, wd, c, co, k, stride, padding,
                ho, wo, stream)
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
    _count(phase_conv.wgrad_variant_launches, variant)
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


def _taps_dgrad(k: int, c: int, co: int) -> bool:
    """Whether the tensor-core data gradients take a conv's channels."""
    return k in (1, 3) and c % 8 == 0 and co % 8 == 0


def dgrad_variant(dy_shape, w_shape, stride: int, padding: int,
                  dtype: torch.dtype) -> str:
    """Which kernel the data gradient of a CUDA tensor takes: the 1x1
    stride-1 convs of :func:`small_1x1_fits` ``"small_1x1"`` (one launch,
    the weights read transposed); other 1x1 and 3x3 convs with C and Co
    multiples of 8 the tensor cores, at stride 1 the forward's
    ``wgmma_taps`` on the flipped weights (``"flipped:wgmma_taps"``), at
    stride 2 ``"wgmma_classes"``; both read Co in zero-filled K runs of
    :func:`taps_run` and write C in the N tiles of :func:`co_tiles`.  Else
    ``"cuda_cores"``."""
    k, _, c, co = w_shape
    if small_1x1_fits(k, stride, c, co):
        return "small_1x1"
    if _taps_dgrad(k, c, co):
        return "flipped:wgmma_taps" if stride == 1 else "wgmma_classes"
    return "cuda_cores"


def phase_conv_dgrad(dy: torch.Tensor, w: torch.Tensor, x_shape, stride: int,
                     padding: int, _cuda_cores: bool = False,
                     _flipped: bool = False) -> torch.Tensor:
    """Data gradient ``x_shape`` of ``phase_conv`` for HWIO ``w`` and output
    gradient ``dy`` ``[B, Ho, Wo, Co]``.  A CPU pair takes the plain version;
    a CUDA pair launches the kernels of :func:`dgrad_variant` or raises
    (for comparisons, ``_cuda_cores`` forces the CUDA-core kernel and
    ``_flipped`` the stride-1 tensor-core route, where its predicate takes
    the shape).  The tensor-core variants first pack the weights in one
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
    if _cuda_cores:
        variant = "cuda_cores"
    elif _flipped:
        if stride != 1 or not _taps_dgrad(k, c, co):
            raise ValueError(f"_flipped: the stride-1 tensor-core route does "
                             f"not take k={k} stride={stride} C={c} Co={co}")
        variant = "flipped:wgmma_taps"
    else:
        variant = dgrad_variant(dy.shape, w.shape, stride, padding, dy.dtype)
    if variant.startswith("flipped:"):
        wp = pack_taps(w, flip_taps(k))
        dx, _ = _launch_forward(dy, w.new_empty((k, k, co, c), device="meta"),
                                1, padding, None, None, None, packed=wp,
                                variant="wgmma_taps")
    else:
        dx = torch.empty(x_shape, dtype=dy.dtype, device=dy.device)
        if dx.numel() == 0:
            return dx
        if dy.numel() == 0:
            return dx.zero_()
        with torch.cuda.device(dy.device):
            stream = torch.cuda.current_stream().cuda_stream
            if variant == "small_1x1":
                _check_aligned(dy)
                err = _small_1x1(dy, w, dx, True, (None, None, 0), stream)
            elif variant == "wgmma_classes":
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
                    wd, c, co, ho, wo, taps_run(co, dy.dtype),
                    co_tiles(c)[0], stream)
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
    _count(phase_conv.dgrad_variant_launches, variant)
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
            _count(phase_conv.variant_launches, variant)
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


def _count(counts: Dict[str, int], variant: str) -> None:
    counts[variant] = counts.get(variant, 0) + 1


def phase_conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None,
               act: Optional[str] = None, _direct: bool = False) -> torch.Tensor:
    """NHWC x HWIO conv with symmetric ``padding``; semantics of
    ``lax.conv_general_dilated`` (and of the JAX ``phase_conv``), then
    ``* scale + shift`` (fp32 ``[Co]``) and ``act`` (``"silu"``) where given.

    Supported: stride 1 with odd k and p=(k-1)//2; stride 2 with odd k and
    p=(k-1)//2 or even k and p=k/2-1, on even H and W.  Anything else
    raises.  Differentiable in ``x`` and ``w`` without the epilogue
    (:class:`PhaseConvFunction`); with it, a CUDA call under autograd raises.

    ``_direct`` sends a CUDA call without autograd to the CUDA-core
    ``direct`` kernel whatever the shape, for comparisons.

    Counters: ``phase_conv.launches`` (forward; ``.fused_launches`` of them
    with the epilogue), ``.wgrad_launches``,
    ``.dgrad_launches``, ``.pack_launches`` (the data gradients' weight
    packing), ``.dy_copies`` (output gradients that arrived non-contiguous
    and were copied to NHWC); ``.variant_launches``,
    ``.wgrad_variant_launches`` and ``.dgrad_variant_launches`` split the
    first three by variant; ``.last_variant``, ``.last_wgrad_variant`` and
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
    y, variant = _launch_forward(x, w, stride, padding, scale, shift, act,
                                 variant="direct" if _direct else None)
    if y.numel():
        phase_conv.launches += 1
        phase_conv.fused_launches += scale is not None
        _count(phase_conv.variant_launches, variant)
        phase_conv.last_variant = variant
    return y


phase_conv.launches = 0
phase_conv.fused_launches = 0
phase_conv.wgrad_launches = 0
phase_conv.dgrad_launches = 0
phase_conv.dy_copies = 0
phase_conv.pack_launches = 0
phase_conv.variant_launches = {}
phase_conv.wgrad_variant_launches = {}
phase_conv.dgrad_variant_launches = {}
phase_conv.last_variant = None
phase_conv.last_wgrad_variant = None
phase_conv.last_dgrad_variant = None
