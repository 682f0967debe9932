"""Build + load the C++ COCO evaluation matcher via ctypes (the port's copy of
ubteacher_tpu.evaluation.native).

Compiles csrc/coco_eval_native.cpp once with g++ into the package's
`_build/` directory, beside the CUDA libraries (plain C ABI + numpy ctypes
pointers). Returns None if no compiler is available; callers fall back to
numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "coco_eval_native.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB = None
_TRIED = False


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"coco_eval_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    # per-process temporary name: concurrent test workers may build at once
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except (subprocess.SubprocessError, OSError):
        return None


def get_lib():
    """ctypes lib with bbox_iou + match_dets, or None."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    f64 = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.bbox_iou.argtypes = [ctypes.c_int, ctypes.c_int, f64, f64, u8, f64]
    lib.bbox_iou.restype = None
    lib.match_dets.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, f64, f64, u8, u8, u8,
        i64, u8, i64,
    ]
    lib.match_dets.restype = None
    _LIB = lib
    return lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def bbox_iou(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None or len(dets) == 0 or len(gts) == 0:
        return None
    dets = np.ascontiguousarray(dets, np.float64)
    gts = np.ascontiguousarray(gts, np.float64)
    iscrowd = np.ascontiguousarray(iscrowd, np.uint8)
    out = np.zeros((len(dets), len(gts)), np.float64)
    lib.bbox_iou(
        len(dets), len(gts),
        _ptr(dets, ctypes.POINTER(ctypes.c_double)),
        _ptr(gts, ctypes.POINTER(ctypes.c_double)),
        _ptr(iscrowd, ctypes.POINTER(ctypes.c_uint8)),
        _ptr(out, ctypes.POINTER(ctypes.c_double)),
    )
    return out


def match_dets(
    iou_thrs: np.ndarray,
    ious: np.ndarray,          # (D, G)
    g_ignore: np.ndarray,      # (G,) bool
    iscrowd: np.ndarray,       # (G,) uint8
    d_out_of_area: np.ndarray, # (D,) bool
):
    """Returns (dt_match (T,D) int64, dt_ignore (T,D) bool, gt_match) or None."""
    lib = get_lib()
    if lib is None:
        return None
    T = len(iou_thrs)
    D, G = ious.shape
    iou_thrs = np.ascontiguousarray(iou_thrs, np.float64)
    ious = np.ascontiguousarray(ious, np.float64)
    g_ignore8 = np.ascontiguousarray(g_ignore, np.uint8)
    iscrowd8 = np.ascontiguousarray(iscrowd, np.uint8)
    d_out8 = np.ascontiguousarray(d_out_of_area, np.uint8)
    dt_match = np.zeros((T, D), np.int64)
    dt_ignore = np.zeros((T, D), np.uint8)
    gt_match = np.zeros((T, G), np.int64)
    f64 = ctypes.POINTER(ctypes.c_double)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.match_dets(
        T, D, G,
        _ptr(iou_thrs, f64), _ptr(ious, f64), _ptr(g_ignore8, u8),
        _ptr(iscrowd8, u8), _ptr(d_out8, u8),
        _ptr(dt_match, i64), _ptr(dt_ignore, u8), _ptr(gt_match, i64),
    )
    return dt_match, dt_ignore.astype(bool), gt_match
