"""The port's tracer: host spans and counters, kept in memory and read in
process, and ``Timers``, the operator log's view of it.

``TRACER`` is the process's one tracer, off by default. Off, ``span`` hands
back a shared context that does nothing and ``count`` returns at its first
branch: no clock read, no allocation. On (inside ``recording()``):

* a span records its name, its start and end on the host clock
  (``time.perf_counter``), the index of the span open around it
  (``parent``), the number of the dispatch it belongs to (``dispatch``: the
  dispatches, or joint chunks, that had ended when it opened, so a
  buffering call's span carries the number of the dispatch that takes its
  frame) and whether a ``torch.profiler`` was recording (``profiled``: the
  span lies in a traced slice);
* while a ``torch.profiler`` records, each span is also a
  ``record_function`` range named ``PREFIX`` + its name, so that in a trace
  the program's spans sit on the profiler's clock beside the device's
  kernels;
* a counter is a named number added at a span's boundary (``count``), kept
  with the time it was added.

Device work is asynchronous: a span holds device time only where the work
inside it ends in a host read or a synchronize. Python runs the device
stages of a CUDA graph (``device_vo.*``) only while the graph is built, so
their spans are host time there; ``pipeline.cuda_graph.Capture.stage_map``
gives the graph's stage map (each device operation of one eager run of the
graph's function, under its innermost stage) for a trace of the replays to
be read by.

``Timers(prefix)`` keeps the ``scope`` / ``summary`` / ``report`` of the
host ``System``'s operator log: its scopes are spans named ``prefix`` +
scope, and its summary reads them back.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

PREFIX = "sdvo/"  # the program's ranges in a torch.profiler trace (the kernels' operators are "sdvo::…")


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: int  # index in ``Tracer.spans`` of the span open around it; -1 at the top
    dispatch: int
    profiled: bool


_OFF = contextlib.nullcontext()


class _Open:
    """A span while it is open (the tracer on)."""

    __slots__ = ("tracer", "name", "ends_dispatch", "index", "dispatch", "start", "range")

    def __init__(self, tracer: "Tracer", name: str, ends_dispatch: bool):
        self.tracer, self.name, self.ends_dispatch = tracer, name, ends_dispatch

    def __enter__(self):
        t = self.tracer
        self.index = len(t.spans)
        self.dispatch = t.dispatches
        t.spans.append(None)  # the place keeps the opening order; filled on exit
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        t._open.append(self.index)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        t = self.tracer
        if self.range is not None:
            self.range.__exit__(*exc)
        t._open.pop()
        parent = t._open[-1] if t._open else -1
        t.spans[self.index] = Span(self.name, self.start, end, parent, self.dispatch, self.range is not None)
        if self.ends_dispatch:
            t.dispatches += 1
        return False


class Tracer:
    """Spans and counters of the port (see the module's docstring). ``spans``
    in the order they opened, ``counts`` [(time, name, value)],
    ``dispatches`` the dispatches ended."""

    def __init__(self):
        self.on = False
        self.reset()

    def reset(self):
        """Forget every span and counter (the switch stays)."""
        self.spans: List[Optional[Span]] = []
        self.counts: List[Tuple[float, str, float]] = []
        self.dispatches = 0
        self._open: List[int] = []

    @contextlib.contextmanager
    def recording(self, on: bool = True):
        """Inside the block the tracer is ``on``; turned on from off, it
        forgets what it held first (a block inside another adds to the outer
        block's record). The switch is put back at the end."""
        was = self.on
        if on and not was:
            self.reset()
        self.on = bool(on)
        try:
            yield self
        finally:
            self.on = was

    def span(self, name: str, ends_dispatch: bool = False):
        """A context that records the span ``name`` while on. With
        ``ends_dispatch`` its exit ends a dispatch (``dispatches`` + 1)."""
        if not self.on:
            return _OFF
        return _Open(self, name, ends_dispatch)

    def count(self, name: str, value: float):
        if not self.on:
            return
        self.counts.append((time.perf_counter(), name, value))

    def sync(self, device: torch.device):
        """While on, wait for ``device``'s work: a span opened next holds host
        work alone, not the wait for the device's."""
        if self.on and device.type == "cuda":
            torch.cuda.synchronize(device)

    # ----------------------------------------------------------- reading
    def closed(self) -> List[Span]:
        return [s for s in self.spans if s is not None]

    def counter(self, name: str) -> float:
        return math.fsum(v for _, n, v in self.counts if n == name)

    def summary(self, prefix: str = "") -> Dict[str, Dict[str, float]]:
        """{name without ``prefix``: total_s, count, mean_ms} of every closed
        span whose name starts with ``prefix``."""
        total: Dict[str, float] = {}
        count: Dict[str, int] = {}
        for s in self.closed():
            if s.name.startswith(prefix):
                k = s.name[len(prefix):]
                total[k] = total.get(k, 0.0) + (s.end - s.start)
                count[k] = count.get(k, 0) + 1
        return {k: {"total_s": total[k], "count": count[k], "mean_ms": 1e3 * total[k] / count[k]} for k in total}

    def report(self, prefix: str = "") -> str:
        lines = ["stage                   count   mean_ms   total_s"]
        for k, v in sorted(self.summary(prefix).items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{k:22s} {v['count']:6d} {v['mean_ms']:9.2f} {v['total_s']:9.2f}")
        return "\n".join(lines)


TRACER = Tracer()


class Timers:
    """The operator log's scope timers over ``TRACER``: ``scope(name)`` is
    the span ``prefix + name``; ``summary`` and ``report`` read those spans
    back (nothing while the tracer is off)."""

    def __init__(self, prefix: str, tracer: Tracer = TRACER):
        self.prefix = prefix
        self.tracer = tracer

    def scope(self, name: str):
        return self.tracer.span(self.prefix + name)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return self.tracer.summary(self.prefix)

    def report(self) -> str:
        return self.tracer.report(self.prefix)
