"""CUDA graphs of the port's chunks: the counterpart of the JAX package's
compiled chunks (``DeviceVO.chunk_fn``, a ``jax.jit`` of ``lax.scan`` over
supersteps; ``StreamingTracker._jit_track``, a ``lax.scan`` over frames; the
jitted scan of the vmapped superstep in ``parallel.multi_seq``), each of
which runs a whole chunk with one host dispatch.

``GraphedCall(fn, name)`` captures ``fn`` the first time it is called on a
card with inputs of a given structure, shapes and types, in a given mode
(``mode()``), and replays that graph for every later such call:

* ``fn`` takes trees of tensors (NamedTuples, tuples, lists; other leaves
  are constants of the call) and returns one. Its shapes must not depend on
  data and it must not read a device value on the host: the superstep, the
  streaming frame step and the vmapped superstep are written so
  (``tests/test_torch_capture.py`` holds them to it).
* One graph for each (card, input spec, mode): the spec is the tree's
  structure, each tensor's shape and type and each constant's value; the
  mode is the process-wide settings that decide which kernels an op
  records (deterministic algorithms, the preferred linear-algebra and BLAS
  libraries, the float32 matmul precision). A call in another mode or
  with other shapes captures its own graph; none replays a graph recorded
  for other settings.
* Capture: the inputs are cloned into static buffers; ``fn`` runs once
  eagerly on clones of those buffers, on a side stream (the warm-up: the
  kernel library's first build and load, cuBLAS/cuSOLVER handles, the first
  allocations), then once under ``torch.cuda.graph`` on the buffers
  themselves, into a private memory pool. The warm-up never touches the
  caller's tensors.
* Replay: the inputs are copied into the static buffers, the graph replays,
  and the outputs are copied out of the pool into fresh tensors (``clone``),
  so that nothing handed back aliases memory the next replay overwrites.
* No fallback: a capture that fails raises, naming the line of the port
  that issued the op the capture could not hold; an input off a CUDA card
  raises.

The kernels' wrappers count their launches in ``module.launches`` while
Python runs them; under replay no Python runs. So a capture leaves the
counters as they were before it (it launches nothing) and remembers how
many launches it recorded (``Capture.captured_launches``), and every replay
adds those: the count is captured launches × replays, plus the warm-up's
real launches (``Capture.warmup_launches``).
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from sdvo_tpu_torch.ops import build

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """(the tensor leaves of ``tree`` in order, its spec): the structure,
    each tensor's shape and type, and every other leaf's value."""
    leaves: List[torch.Tensor] = []

    def spec(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("tensor", tuple(x.shape), x.dtype)
        if isinstance(x, (tuple, list)):
            return (type(x), tuple(spec(y) for y in x))
        return ("const", x)

    return leaves, spec(tree)


def unflatten(spec, leaves: List[torch.Tensor]):
    """The tree of ``spec`` with ``leaves`` in place of its tensors."""
    it = iter(leaves)

    def build_(s):
        kind = s[0]
        if kind == "tensor":
            return next(it)
        if kind == "const":
            return s[1]
        children = [build_(c) for c in s[1]]
        return kind(*children) if hasattr(kind, "_fields") else kind(children)

    return build_(spec)


def _launch_counts() -> Dict[str, int]:
    return {k: m.launches for k, m in build.kernel_modules().items()}


def _where(err: BaseException) -> str:
    """The innermost line of the port (outside this file) in the tracebacks
    of ``err`` and of the exceptions it was raised from or during."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        frames = [f for f in traceback.extract_tb(err.__traceback__)
                  if f.filename.startswith(_PKG) and not f.filename.endswith("cuda_graph.py")]
        if frames:
            f = frames[-1]
            return f"{os.path.relpath(f.filename, os.path.dirname(_PKG))}:{f.lineno}: {f.line}"
        err = err.__cause__ or err.__context__
    return "an unknown line"


def mode() -> tuple:
    """The process-wide settings that decide which kernels a capture records:
    deterministic algorithms (on, warn only, filling new memory), the
    preferred linear-algebra and BLAS libraries, the float32 matmul
    precision. Part of a graph's key."""
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory,
            str(torch.backends.cuda.preferred_linalg_library()),
            str(torch.backends.cuda.preferred_blas_library()),
            torch.get_float32_matmul_precision())


class Capture:
    """One captured graph of a ``GraphedCall``: ``capture_seconds`` (warm-up
    and capture, host clock), ``pool_bytes`` (what
    ``torch.cuda.memory_reserved`` grew by over the capture: the graph's
    private pool), ``warmup_launches`` and ``captured_launches`` (each
    kernel's launches in the warm-up and in one replay) and ``replays``."""

    def __init__(self, fn: Callable, name: str, device: torch.device, spec, leaves: List[torch.Tensor]):
        t0 = time.perf_counter()
        self.static_in = [x.clone() for x in leaves]
        before = _launch_counts()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*unflatten(spec, [x.clone() for x in self.static_in]))
        torch.cuda.current_stream(device).wait_stream(side)
        self.warmup_launches = {k: n - before[k] for k, n in _launch_counts().items()}
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        try:
            with torch.cuda.device(device), torch.cuda.graph(graph):
                out = fn(*unflatten(spec, self.static_in))
        except Exception as err:
            raise RuntimeError(f"{name}: CUDA graph capture failed at {_where(err)}: {err}") from err
        finally:
            # a capture records launches and makes none
            after = _launch_counts()
            for k, m in build.kernel_modules().items():
                m.launches = before[k]
        self.captured_launches = {k: after[k] - before[k] for k in before}
        self.static_out, self.out_spec = flatten(out)
        torch.cuda.synchronize(device)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
        self.replays = 0


class GraphedCall:
    """``fn`` captured as a CUDA graph at its first call for each (card,
    input spec, ``mode()``) and replayed at every later one (see the
    module's docstring). ``name`` names it in errors. ``graphs`` maps each
    key to its ``Capture``; ``last`` is the capture the last call replayed."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        self.graphs: Dict[tuple, Capture] = {}
        self.last: Optional[Capture] = None

    def __call__(self, *args):
        leaves, spec = flatten(args)
        devices = {x.device for x in leaves}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"{self.name}: the inputs lie on {sorted(map(str, devices))}, not on one CUDA card")
        (device,) = devices
        key = (device, spec, mode())
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = Capture(self.fn, self.name, device, spec, leaves)
        for dst, src in zip(g.static_in, leaves):
            dst.copy_(src)
        try:
            g.graph.replay()
        except RuntimeError as err:
            raise RuntimeError(f"{self.name}: CUDA graph replay failed: {err}") from err
        g.replays += 1
        self.last = g
        for k, m in build.kernel_modules().items():
            m.launches += g.captured_launches[k]
        return unflatten(g.out_spec, [x.clone() for x in g.static_out])
