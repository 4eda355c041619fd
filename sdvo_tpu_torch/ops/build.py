"""Build and bind the hand-written Hopper kernels of ``sdvo_tpu_torch/csrc``.

``library()`` compiles every ``csrc/*.cu`` with nvcc into
``build/libsdvo_tpu_torch_kernels.so`` (beside the package) on first use —
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` — and loads it with ctypes. The sources expose a plain C
interface (no PyTorch headers), so the build takes seconds. Each C entry
point launches on the given stream and returns ``cudaGetLastError()``;
``check`` turns a non-zero code into an exception.

Nothing here runs at import time: CPU-only installs import the package and
never touch nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libsdvo_tpu_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build (None: reused)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "sdvo_lm_align_level": [_P] * 7 + [_F] * 4 + [_P] * 3 + [_I] * 5 + [_F, _P],
    "sdvo_fa_align": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
    "sdvo_pose_refine": [_P] * 6 + [_I, _I, _F, _P],
    "sdvo_depth_scores": [_P] * 5 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _stale(sources) -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first when missing or stale."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if _stale(sources + headers):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = LIB_PATH + f".tmp{os.getpid()}"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {code})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_inputs(name: str, device: torch.device, shapes: dict, **tensors):
    """Wrapper-side checks before a launch: every tensor float32, contiguous,
    on ``device`` and of the shape ``shapes[key]``."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shapes[key]}")
