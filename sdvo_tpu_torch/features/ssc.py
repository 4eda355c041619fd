"""SSC adaptive non-maximal suppression — port of ``sdvo_tpu.features.ssc``.

Same choice rule as the reference: the native helpers of
``native/libsdvo_host.so`` through ctypes when the library loads, the numpy
route otherwise. The library is built on first use with ``make -C native``
when its source is present and the shared object is not. Both routes
implement the published SSC algorithm; the native threshold extraction
orders equal responses as ``std::sort`` does, so parity with the JAX package
holds when both use the same route.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO, "native")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(_NATIVE, "libsdvo_host.so")
    if not os.path.exists(path) and os.path.exists(os.path.join(_NATIVE, "Makefile")):
        subprocess.run(["make", "-C", _NATIVE], check=False, capture_output=True)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    i32 = ctypes.c_int32
    lib.sdvo_ssc_select.restype = i32
    lib.sdvo_ssc_select.argtypes = [fp, fp, i32, i32, ctypes.c_float, i32, i32,
                                    ctypes.POINTER(i32)]
    lib.sdvo_threshold_extract.restype = i32
    lib.sdvo_threshold_extract.argtypes = [ctypes.POINTER(ctypes.c_uint8), i32, i32, i32, fp, fp,
                                           fp, i32]
    lib.sdvo_bucket_points.restype = i32
    lib.sdvo_bucket_points.argtypes = [fp, fp, i32, i32, i32, i32, ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.POINTER(i32)]
    _LIB = lib
    return lib


def have_native() -> bool:
    """Whether the ctypes loader found (or built) ``native/libsdvo_host.so``."""
    return _load_lib() is not None


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def ssc_select(xs, ys, num_ret_points: int, tolerance: float, cols: int, rows: int) -> np.ndarray:
    """Indices (into the response-sorted input) of ~num_ret_points points."""
    xs, ys = _f32(xs), _f32(ys)
    n = xs.shape[0]
    lib = _load_lib()
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        count = lib.sdvo_ssc_select(_ptr(xs, ctypes.c_float), _ptr(ys, ctypes.c_float), n,
                                    int(num_ret_points), float(tolerance), int(cols), int(rows),
                                    _ptr(out, ctypes.c_int32))
        return out[:count]
    return _ssc_numpy(xs, ys, num_ret_points, tolerance, cols, rows)


def _ssc_numpy(xs, ys, num_ret_points, tolerance, cols, rows) -> np.ndarray:
    n = xs.shape[0]
    if n == 0 or num_ret_points <= 0:
        return np.empty(0, dtype=np.int32)
    if n <= num_ret_points:
        return np.arange(n, dtype=np.int32)
    K = num_ret_points
    exp1 = rows + cols + 2 * K
    exp2 = 4 * cols + 4 * K + 4 * rows * K + rows * rows + cols * cols - 2 * rows * cols + 4 * rows * cols * K
    exp3 = np.sqrt(float(exp2))
    exp4 = 2.0 * (K - 1)
    high = int(max(-round((exp1 + exp3) / exp4), -round((exp1 - exp3) / exp4)))
    low = int(np.sqrt(n / K))
    kmin = round(K - K * tolerance)
    kmax = round(K + K * tolerance)
    prev_width = -1
    result = prev_result = np.empty(0, dtype=np.int32)
    while True:
        width = low + (high - low) // 2
        if width == prev_width or low > high:
            result = prev_result
            break
        c = width / 2.0
        ncols, nrows = int(cols / c), int(rows / c)
        covered = np.zeros((nrows + 1, ncols + 1), dtype=bool)
        reach = int(width / c)
        sel = []
        rr = (ys / c).astype(np.int32)
        cc = (xs / c).astype(np.int32)
        for i in range(n):
            r, col = rr[i], cc[i]
            if r > nrows or col > ncols:
                continue
            if not covered[r, col]:
                sel.append(i)
                covered[max(r - reach, 0): min(r + reach, nrows) + 1,
                        max(col - reach, 0): min(col + reach, ncols) + 1] = True
        result = np.asarray(sel, dtype=np.int32)
        if kmin <= len(sel) <= kmax:
            break
        if len(sel) < kmin:
            high = width - 1
        else:
            low = width + 1
        prev_width = width
        prev_result = result
    return result


def threshold_extract(grad: np.ndarray, threshold: int, max_out: int = 100000
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pixels with response > threshold, strongest first: (x, y, response)."""
    grad_u8 = np.ascontiguousarray(np.clip(grad, 0, 255), dtype=np.uint8)
    lib = _load_lib()
    if lib is not None:
        out = [np.empty(max_out, np.float32) for _ in range(3)]
        count = lib.sdvo_threshold_extract(
            _ptr(grad_u8, ctypes.c_uint8), grad_u8.shape[0], grad_u8.shape[1], int(threshold),
            *(_ptr(o, ctypes.c_float) for o in out), max_out)
        return out[0][:count], out[1][:count], out[2][:count]
    ys, xs = np.nonzero(grad_u8 > threshold)
    resp = grad_u8[ys, xs].astype(np.float32)
    order = np.argsort(-resp, kind="stable")[:max_out]
    return xs[order].astype(np.float32), ys[order].astype(np.float32), resp[order]


def bucket_points(xs, ys, cell_size: int, grid_cols: int, grid_rows: int, occupancy: np.ndarray):
    """One point per free grid cell; returns (occupancy, kept indices)."""
    xs, ys = _f32(xs), _f32(ys)
    occupancy = np.ascontiguousarray(occupancy, dtype=np.uint8)
    lib = _load_lib()
    if lib is not None:
        keep = np.empty(xs.shape[0], dtype=np.int32)
        count = lib.sdvo_bucket_points(_ptr(xs, ctypes.c_float), _ptr(ys, ctypes.c_float),
                                       xs.shape[0], int(cell_size), int(grid_cols), int(grid_rows),
                                       _ptr(occupancy, ctypes.c_uint8), _ptr(keep, ctypes.c_int32))
        return occupancy, keep[:count]
    kept = []
    for i in range(xs.shape[0]):
        cx, cy = int(xs[i]) // cell_size, int(ys[i]) // cell_size
        if 0 <= cx < grid_cols and 0 <= cy < grid_rows and not occupancy[cy, cx]:
            occupancy[cy, cx] = 1
            kept.append(i)
    return occupancy, np.asarray(kept, dtype=np.int32)
