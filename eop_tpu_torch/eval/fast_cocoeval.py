"""The COCO matcher in C++ (``csrc/cocoeval.cpp``, a copy of
``eop_tpu/layers/csrc/cocoeval.cpp``) bound with ctypes (counterpart of
``eop_tpu/layers/fast_cocoeval.py``).

The library is built for the host on first use by ``_build`` with the host's
C++ compiler, into ``eop_tpu_torch/_build/``.  A failed build raises with the
compiler's output: evaluation does not fall back to Python.
:func:`match_image_py` is the plain version the tests hold the native
matcher against.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .. import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("cocoeval")
    fn = lib.cocoeval_match_image
    if fn.restype is not None:  # declare once
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        p_f64 = ctypes.POINTER(ctypes.c_double)
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       p_f64, p_f64, p_i32, p_i32, p_i32, p_i64, p_i64, p_i32]
        fn.restype = None
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def match_image_py(iou_thrs, iou, gt_ignore, gt_iscrowd, dt_out_of_range):
    """Plain Python matcher with the native one's semantics (tests only)."""
    T = len(iou_thrs)
    D, G = len(dt_out_of_range), len(gt_ignore)
    dtm = np.zeros((T, D), np.int64)
    gtm = np.zeros((T, G), np.int64)
    dti = np.zeros((T, D), np.int32)
    for t, thr in enumerate(iou_thrs):
        for d in range(D):
            best = min(thr, 1 - 1e-10)
            m = -1
            for g in range(G):
                if gtm[t, g] > 0 and not gt_iscrowd[g]:
                    continue
                if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                    break
                if iou[d, g] < best:
                    continue
                best = iou[d, g]
                m = g
            if m >= 0:
                dtm[t, d] = m + 1
                gtm[t, m] = d + 1
                dti[t, d] = gt_ignore[m]
        dti[t] |= ((dtm[t] == 0) & (np.asarray(dt_out_of_range) != 0)
                   ).astype(np.int32)
    return dtm, gtm, dti


def match_image(iou_thrs: np.ndarray, iou: np.ndarray, gt_ignore: np.ndarray,
                gt_iscrowd: np.ndarray, dt_out_of_range: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy COCO matcher for one (image, category, area range) cell, in
    C++.

    ``iou`` ``[D, G]`` float64, detections sorted by score (best first) and
    ground truths with the ignored ones last; flags int32.  Returns
    (dt_matches ``[T, D]``, gt_matches ``[T, G]``, dt_ignores ``[T, D]``):
    matched index + 1, 0 for none.
    """
    iou_thrs = np.ascontiguousarray(iou_thrs, np.float64)
    gt_ignore = np.ascontiguousarray(gt_ignore, np.int32)
    gt_iscrowd = np.ascontiguousarray(gt_iscrowd, np.int32)
    dt_out_of_range = np.ascontiguousarray(dt_out_of_range, np.int32)
    T, D, G = len(iou_thrs), len(dt_out_of_range), len(gt_ignore)
    iou = np.ascontiguousarray(iou, np.float64)
    if iou.shape != (D, G) or len(gt_iscrowd) != G:
        raise ValueError(f"iou {iou.shape} against {D} detections and {G} "
                         f"ground truths ({len(gt_iscrowd)} crowd flags)")
    dtm = np.zeros((T, D), np.int64)
    gtm = np.zeros((T, G), np.int64)
    dti = np.zeros((T, D), np.int32)
    _lib().cocoeval_match_image(
        T, D, G,
        _ptr(iou_thrs, ctypes.c_double), _ptr(iou, ctypes.c_double),
        _ptr(gt_ignore, ctypes.c_int32), _ptr(gt_iscrowd, ctypes.c_int32),
        _ptr(dt_out_of_range, ctypes.c_int32),
        _ptr(dtm, ctypes.c_int64), _ptr(gtm, ctypes.c_int64),
        _ptr(dti, ctypes.c_int32))
    match_image.native_calls += 1
    return dtm, gtm, dti


match_image.native_calls = 0  # cells matched by the C++ library
