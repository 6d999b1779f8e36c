"""ctypes bindings for the native host-side point-cloud runtime.

Loads ``libdicp_pointcloud.so`` (built from ``native/pointcloud.cpp`` — a C++
hash-grid voxel filter, range filter, and .bin scan I/O), compiling it on
first use if g++ is available.  Every entry point has a pure-NumPy fallback
with identical semantics, so the package works without a toolchain; the
native path is ~10-30x faster on 100k-point scans.  Host preprocessing, not a
device fallback.

A copy of ``dicp_tpu/io/native.py`` (ctypes and numpy); the C++ source and
its Makefile are shared in place at the repository root's ``native/``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdicp_pointcloud.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if not os.path.exists(_LIB_PATH) and os.path.isdir(_NATIVE_DIR):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True, timeout=120)
            except Exception:
                return None
        if not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None

        i64, i32, f32p = ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_float)
        lib.pc_load_bin.restype = i64
        lib.pc_load_bin.argtypes = [ctypes.c_char_p, f32p, i64, i32]
        lib.pc_save_bin.restype = i64
        lib.pc_save_bin.argtypes = [ctypes.c_char_p, f32p, i64, i32]
        lib.pc_voxel_downsample.restype = i64
        lib.pc_voxel_downsample.argtypes = [f32p, i64, i32, ctypes.c_float, f32p, f32p]
        lib.pc_range_filter.restype = i64
        lib.pc_range_filter.argtypes = [f32p, i64, i32, ctypes.c_float,
                                        ctypes.c_float, f32p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_bin(path: str, stride: int = 4, max_points: int = 1 << 22) -> np.ndarray:
    """Read a KITTI-style .bin scan -> (n, stride) float32 (x, y, z first)."""
    lib = _load_lib()
    if lib is None:
        # mirror the native path's semantics exactly:
        # silently drop a trailing partial record, cap at max_points
        data = np.fromfile(path, dtype=np.float32)
        n = data.size // stride
        return data[:n * stride].reshape(n, stride)[:max_points]
    out = np.empty((max_points, stride), np.float32)
    n = lib.pc_load_bin(path.encode(), _fptr(out), max_points, stride)
    if n < 0:
        raise IOError(f"cannot read {path}")
    return out[:n].copy()


def save_bin(path: str, points: np.ndarray) -> None:
    """Write an (n, c) float32 array as a .bin scan."""
    pts = np.ascontiguousarray(points, np.float32)
    lib = _load_lib()
    if lib is None:
        pts.tofile(path)
        return
    n = lib.pc_save_bin(path.encode(), _fptr(pts), pts.shape[0], pts.shape[1])
    if n != pts.shape[0]:
        raise IOError(f"short write to {path}")


def voxel_downsample_host(points: np.ndarray, voxel: float,
                          return_weight: bool = False):
    """Hash-grid voxel averaging on the host: (n, c<=8) -> (m, c), m <= n.

    All columns are averaged per cell (normals included); output order is by
    first occurrence (deterministic).  Matches the device-side
    :func:`dicp_tpu_torch.ops.voxel.voxel_downsample` semantics up to ordering.

    Cell keys pack 21 bits per axis, so the cloud may span at most 2**21
    (~2.1M) cells along each axis (e.g. 210 km at a 0.1 m voxel); wider
    extents would silently alias cells 2**21 apart, so they raise instead.
    """
    pts = np.ascontiguousarray(points, np.float32)
    n, stride = pts.shape
    if n:
        cmin = np.floor(pts[:, :3].min(axis=0) / voxel)
        cmax = np.floor(pts[:, :3].max(axis=0) / voxel)
        span = cmax - cmin
        if np.any(span >= float(1 << 21)):
            ax = "xyz"[int(np.argmax(span))]
            raise ValueError(
                f"voxel_downsample_host: cloud spans {int(span.max())} cells "
                f"along {ax} (max 2**21 = {1 << 21} per axis at voxel="
                f"{voxel}); increase the voxel size or tile the cloud")
    lib = _load_lib()
    if lib is not None and stride <= 8:
        out = np.empty_like(pts)
        w = np.empty((n,), np.float32)
        m = lib.pc_voxel_downsample(_fptr(pts), n, stride, voxel, _fptr(out), _fptr(w))
        if m < 0:
            raise ValueError("voxel_downsample: bad arguments")
        return (out[:m].copy(), w[:m].copy()) if return_weight else out[:m].copy()

    # NumPy fallback: identical semantics — cell indices in DOUBLE like the
    # native path (floor(p * (double)(1/voxel))); f32 division puts boundary
    # points in different cells than the C++ build
    cells = np.floor(pts[:, :3].astype(np.float64)
                     * (np.float64(1.0) / voxel)).astype(np.int64) & 0x1FFFFF
    key = (cells[:, 0] << 42) | (cells[:, 1] << 21) | cells[:, 2]
    uniq, first, inv, counts = np.unique(key, return_index=True,
                                         return_inverse=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    sums = np.zeros((uniq.size, stride), np.float64)
    np.add.at(sums, inv, pts)
    cent = (sums[order] / counts[order][:, None]).astype(np.float32)
    w = counts[order].astype(np.float32)
    return (cent, w) if return_weight else cent


def range_filter(points: np.ndarray, min_range: float = 0.0,
                 max_range: float = np.inf) -> np.ndarray:
    """Keep points with min_range <= |xyz| <= max_range."""
    pts = np.ascontiguousarray(points, np.float32)
    lib = _load_lib()
    if lib is None or not np.isfinite(max_range):
        r2 = np.sum(pts[:, :3].astype(np.float64) ** 2, axis=-1)
        keep = (r2 >= min_range**2) & (r2 <= max_range**2)
        return pts[keep].copy()
    out = np.empty_like(pts)
    m = lib.pc_range_filter(_fptr(pts), pts.shape[0], pts.shape[1],
                            min_range, max_range, _fptr(out))
    return out[:m].copy()
