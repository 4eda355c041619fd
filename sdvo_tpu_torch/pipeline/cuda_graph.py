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
  caller's tensors. Python's cyclic garbage collector runs just before the
  capture and is off during it: a dead object that holds a CUDA graph (a
  dropped ``DeviceSystem``: its ``DeviceVO`` and ``GraphedCall`` refer to
  each other) resets that graph when it is collected, and a reset during a
  capture invalidates the capture (PyTorch's ``torch.cuda.graph`` no
  longer collects at its entry).
* Replay: the inputs are copied into the static buffers, the graph replays,
  and the outputs are copied out of the pool into fresh tensors (``clone``),
  so that nothing handed back aliases memory the next replay overwrites.
* No fallback: a capture that fails raises, naming the line of the port
  that issued the op the capture could not hold; an input off a CUDA card
  raises.
* Spans (``utils.timing.TRACER``, while it is on): ``graph.warmup`` around
  the warm-up and its synchronize, and on every call ``graph.replay``
  holding ``graph.copy_in``, ``graph.launch`` and ``graph.clone``. Nothing
  of the tracer runs inside the captured code: the graph is the same with
  the tracer on or off.
* ``Capture.stage_map()``, asked for after the capture (a traced run of
  the benchmark asks after its window): ``fn`` runs eagerly once more on
  clones of the static inputs, in the capture's settings, with the tracer
  on, under ``torch.profiler`` (the launch counters are left as they
  were), and the capture keeps that run's *stage map*: every device
  operation it launched, in order, named as the profiler names it, beside
  the innermost program range open when it was launched (the device stages
  of ``DeviceVO``). The graph records the same operations in the same order
  (an eager copy between buffers may run as a kernel where the graph holds
  a copy node), so a trace of a replay is read by it.

The kernels' wrappers count their launches in ``module.launches`` while
Python runs them; under replay no Python runs. So a capture leaves the
counters as they were before it (it launches nothing) and remembers how
many launches it recorded (``Capture.captured_launches``), and every replay
adds those: the count is captured launches × replays, plus the warm-up's
real launches (``Capture.warmup_launches``).
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from sdvo_tpu_torch.ops import build
from sdvo_tpu_torch.utils.timing import PREFIX, TRACER

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


def _settings() -> tuple:
    """The process-wide settings of ``mode()``, as PyTorch takes them back."""
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory,
            torch.backends.cuda.preferred_linalg_library(),
            torch.backends.cuda.preferred_blas_library(),
            torch.get_float32_matmul_precision())


def mode() -> tuple:
    """The process-wide settings that decide which kernels a capture records:
    deterministic algorithms (on, warn only, filling new memory), the
    preferred linear-algebra and BLAS libraries, the float32 matmul
    precision. Part of a graph's key."""
    det, warn, fill, linalg, blas, precision = _settings()
    return det, warn, fill, str(linalg), str(blas), precision


@contextlib.contextmanager
def _settings_as(settings: tuple):
    """The process-wide ``settings`` (a ``_settings()``) inside the block."""
    def put(s):
        det, warn, fill, linalg, blas, precision = s
        torch.use_deterministic_algorithms(det, warn_only=warn)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        torch.backends.cuda.preferred_linalg_library(linalg)
        torch.backends.cuda.preferred_blas_library(blas)
        torch.set_float32_matmul_precision(precision)

    was = _settings()
    put(settings)
    try:
        yield
    finally:
        put(was)


# the CUDA API calls that put one operation on the device
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
             "cudaMemsetAsync")
RUN = "stage_map.run"  # the profiler range around the run a stage map is taken from
# device operations launched and waited for before that run: a profiler
# session that follows another in one process was seen to lose its first
# device operations (2 to 64 of them)
PREROLL = 256


def stage_map(prof) -> Optional[Tuple[Tuple[str, str], ...]]:
    """The stage map of a finished ``torch.profiler.profile`` around one
    eager run (inside a ``RUN`` range, where the trace holds one): each
    device operation (kernel, copy, fill) launched inside it, in the
    order it ran, as (its name, the innermost ``PREFIX`` range open on the
    host when it was launched, without the prefix; "" where none was). A
    launch is found by its runtime call's correlation id (CUDA's own), else
    by the operator it was issued from; an operation with neither counts
    where it started inside the run. None where the trace lost an
    operation: a launching call inside the run whose operation it does not
    hold."""
    events = list(prof.profiler.kineto_results.events())
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    run = [(e.start_ns(), e.end_ns()) for e in events if e.device_type() == cpu and e.name() == RUN]
    lo, hi = run[0] if run else (-math.inf, math.inf)
    ranges, calls, launches, ops, device = [], {}, set(), {}, []
    for e in events:
        name, t = e.name(), e.start_ns()
        if e.device_type() == cpu:
            if name.startswith(PREFIX):
                ranges.append((t, e.end_ns(), name[len(PREFIX):]))
            elif name.startswith("cu"):  # a CUDA API call
                calls[e.correlation_id()] = t
                if name.startswith(_LAUNCHES) and lo <= t <= hi:
                    launches.add(e.correlation_id())
            elif "::" in name:  # an operator
                ops[e.correlation_id()] = t
        elif e.device_type() == cuda and not name.startswith(PREFIX) and name != RUN:
            device.append((t, e.correlation_id(), e.linked_correlation_id(), name))
    if launches - {corr for _, corr, _, _ in device}:
        return None

    def stage(t) -> str:
        inside = [(b - a, n) for a, b, n in ranges if a <= t <= b]
        return min(inside)[1] if inside else ""

    out = []
    for t, corr, linked, name in sorted(device):
        host = calls.get(corr, ops.get(linked))
        if (lo <= host <= hi) if host is not None else t >= lo:  # launched inside the run
            out.append((name, "" if host is None else stage(host)))
    return tuple(out)


def _profiled_run(fn, args, device: torch.device) -> Optional[Tuple[Tuple[str, str], ...]]:
    """``fn(*args)`` once more under ``torch.profiler`` with the tracer on,
    after ``PREROLL`` small operations, the kernels' launch counters left as
    they were; its stage map, or None where a profiler records already or
    this one saw no device operation or lost one."""
    if torch.autograd._profiler_enabled():
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    before = _launch_counts()
    scratch = torch.zeros(1, device=device)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PREROLL):
                scratch.add_(1)
            torch.cuda.synchronize(device)
            with TRACER.recording(), record_function(RUN):
                fn(*args)
                torch.cuda.synchronize(device)
    finally:
        for k, m in build.kernel_modules().items():
            m.launches = before[k]
    return stage_map(prof) or None


class Capture:
    """One captured graph of a ``GraphedCall``: ``capture_seconds`` (warm-up
    and capture, host clock), ``pool_bytes`` (what
    ``torch.cuda.memory_reserved`` grew by over the capture: the graph's
    private pool), ``warmup_launches`` and ``captured_launches`` (each
    kernel's launches in the warm-up and in one replay), ``replays``, and
    ``stage_map()`` (see the module's docstring)."""

    def __init__(self, fn: Callable, name: str, device: torch.device, spec, leaves: List[torch.Tensor]):
        t0 = time.perf_counter()
        self.fn, self.device, self.spec, self.settings = fn, device, spec, _settings()
        self.static_in = [x.clone() for x in leaves]
        before = _launch_counts()
        side = torch.cuda.Stream(device)
        with TRACER.span("graph.warmup"):
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                fn(*unflatten(spec, [x.clone() for x in self.static_in]))
            torch.cuda.current_stream(device).wait_stream(side)
            self.warmup_launches = {k: n - before[k] for k, n in _launch_counts().items()}
            torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device), torch.cuda.graph(graph):
                out = fn(*unflatten(spec, self.static_in))
        except Exception as err:
            raise RuntimeError(f"{name}: CUDA graph capture failed at {_where(err)}: {err}") from err
        finally:
            if collecting:
                gc.enable()
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
        self._stage_map = None

    def stage_map(self) -> Optional[Tuple[Tuple[str, str], ...]]:
        """The graph's stage map (see the module's docstring), taken at the
        first call that gets one and kept; None where a profiler records
        already or the trace lost an operation."""
        if self._stage_map is None:
            with _settings_as(self.settings):
                args = unflatten(self.spec, [x.clone() for x in self.static_in])
                self._stage_map = _profiled_run(self.fn, args, self.device)
        return self._stage_map


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
        with TRACER.span("graph.replay"):
            with TRACER.span("graph.copy_in"):
                for dst, src in zip(g.static_in, leaves):
                    dst.copy_(src)
            with TRACER.span("graph.launch"):
                try:
                    g.graph.replay()
                except RuntimeError as err:
                    raise RuntimeError(f"{self.name}: CUDA graph replay failed: {err}") from err
            g.replays += 1
            self.last = g
            for k, m in build.kernel_modules().items():
                m.launches += g.captured_launches[k]
            with TRACER.span("graph.clone"):
                return unflatten(g.out_spec, [x.clone() for x in g.static_out])
