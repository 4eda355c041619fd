"""Build and bind the hand-written Hopper kernels of ``sdvo_tpu_torch/csrc``.

``library()`` compiles every ``csrc/*.cu`` with nvcc (``-gencode
arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC``, one nvcc per
source, all started together), links the objects into
``build/libsdvo_tpu_torch_kernels.so`` (beside the package) on first use and
loads it with ctypes. The sources expose a plain C interface (no PyTorch
headers), so the build takes seconds. Each C entry point launches on the
given stream and returns ``cudaGetLastError()``; ``check`` turns a non-zero
code into an exception.

Each kernel's wrapper calls an operator ``sdvo::<name>`` (``define_op``)
whose CPU implementation is the kernel's plain version and whose CUDA
implementation launches the kernel, with a ``torch.func.vmap`` rule, so
that the multi-sequence path (``sdvo_tpu_torch.parallel``) batches it: one
launch for every sequence of the batch on the card, one plain call per
sequence on the CPU.

Nothing is built at import time (the operators are only defined): CPU-only
installs import the package and never touch nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
from typing import Callable, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libsdvo_tpu_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "sdvo_lm_align_level": [_P] * 7 + [_F] * 4 + [_P] * 2 + [_I] * 5 + [_F, _I, _I, _P],
    "sdvo_fa_align": [_P] * 10 + [_I] * 5 + [_F, _F, _P],
    "sdvo_pose_refine": [_P] * 6 + [_I, _I, _F, _I, _P],
    "sdvo_depth_scores": [_P] * 5 + [_I] * 5 + [_P],
    "sdvo_empty_launch": [_P],
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


def _compile(sources):
    """One nvcc per source, all at once, then the link."""
    nvcc = _nvcc()
    obj_dir = os.path.join(BUILD_DIR, f"obj{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    objects = [os.path.join(obj_dir, os.path.basename(s)[:-3] + ".o") for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objects)]
    logs = [p.communicate()[0] for p in procs]
    failed = [f"{s}:\n{log}" for s, p, log in zip(sources, procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = LIB_PATH + f".tmp{os.getpid()}"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, LIB_PATH)
    shutil.rmtree(obj_dir, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first when missing or stale."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if _stale(sources + headers):
        os.makedirs(BUILD_DIR, exist_ok=True)
        _compile(sources)
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def kernel_modules() -> dict:
    """The four kernels' wrapper modules by kernel name, each with its
    ``launches`` and ``plain_cuda_calls`` counters."""
    from sdvo_tpu_torch.ops import depth_scores, fa_align, lm_align, pose_refine

    return {"lm_align_level": lm_align, "fa_align_batch": fa_align, "pose_refine": pose_refine,
            "depth_scores": depth_scores}


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {code})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launcher(module, name: str, symbol: str, args: tuple, device: torch.device, tensors: tuple):
    """``launch()`` that enqueues the kernel ``symbol(*args, stream)`` alone
    on ``device``'s current stream, raises on a refused launch and counts it
    in ``module.launches``. ``tensors`` are those whose pointers ``args``
    holds, outputs included: they live as long as ``launch`` does, so a
    launch kept without its outputs (``selfcheck.cold_launches``) never
    writes into memory the allocator has handed on."""
    fn = getattr(library(), symbol)

    def launch():
        check(fn(*args, stream_ptr(device)), name)
        module.launches += 1

    launch.tensors = tensors
    return launch


def check_inputs(name: str, device: torch.device, shapes: dict, dtypes: Optional[dict] = None,
                 **tensors):
    """Wrapper-side checks before a launch: every tensor contiguous, on
    ``device``, of the shape ``shapes[key]`` and of the type ``dtypes[key]``
    (float32 where not named)."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {device}")
        want = (dtypes or {}).get(key, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shapes[key]}")


_OPS_LIB = torch.library.Library("sdvo", "DEF")


def define_op(name: str, schema: str, plain: Callable, cuda: Callable):
    """The operator ``sdvo::<name>`` of ``schema`` (it returns a tuple of
    tensors): ``plain`` on CPU tensors, ``cuda`` (one launch) on CUDA
    tensors, and a ``torch.func.vmap`` rule. On CPU tensors the rule calls
    the op once per member of the batch, so that each gets exactly the
    result of its own call. On CUDA tensors it moves the batch to the front
    of every tensor, expands the tensors that have none, makes them
    contiguous and calls ``cuda`` once: one launch for the whole batch.
    Returns the function the wrapper calls: outside ``torch.func.vmap`` (no
    argument is a functorch tensor) it calls ``plain`` or ``cuda`` itself,
    so that a one-problem call pays no dispatch; inside, the op."""
    _OPS_LIB.define(name + schema)
    _OPS_LIB.impl(name, plain, "CPU")
    _OPS_LIB.impl(name, cuda, "CUDA")
    op = getattr(torch.ops.sdvo, name).default

    def rule(info, in_dims, *args):
        B = info.batch_size
        first = next(a for a, d in zip(args, in_dims) if d is not None)
        if not first.is_cuda:
            calls = [op(*[a.select(d, b) if d is not None else a for a, d in zip(args, in_dims)])
                     for b in range(B)]
            outs = tuple(torch.stack(o) for o in zip(*calls))
        else:
            outs = cuda(*[
                a.movedim(d, 0).contiguous() if d is not None
                else a.expand(B, *a.shape).contiguous() if isinstance(a, torch.Tensor) else a
                for a, d in zip(args, in_dims)])
        return outs, (0,) * len(outs)

    torch.library.register_vmap(f"sdvo::{name}", rule, lib=_OPS_LIB)
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor

    def call(*args):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if any(wrapped(a) for a in tensors):
            return op(*args)
        return (cuda if tensors[0].is_cuda else plain)(*args)

    return call
