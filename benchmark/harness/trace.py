"""What the harness reads from a ``torch.profiler`` trace of a slice of the
window: each device kernel's interval and name, the host ranges the harness
itself opened (``record_function``), and from them the device's busy time
(the union of kernel intervals, overlaps once), kernel time by name, and
the idle gaps labelled by the harness range the host was in.

``Slice`` is that reduction, and what the per-layer readers take: its
fields are plain numbers and lists, so a synthetic trace builds one for the
tests (``Slice.from_intervals``)."""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

HOST_PREFIX = "bench:"  # the harness's own ranges


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """The seconds covered by ``intervals`` ((start, end) in seconds),
    overlaps counted once."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    gaps, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [g for g in gaps if g[1] > g[0]]


def is_copy(name: str) -> bool:
    """Whether a device operation is a copy or a fill, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


class Slice:
    """A traced slice: ``kernels`` [(name, start s, end s)] (every device
    operation: kernels, copies and fills), ``ranges``
    [(name, start s, end s)] of the harness's host ranges, ``lo``/``hi`` the
    slice's bounds in the trace's clock (seconds), ``frames`` and
    ``supersteps`` the work the slice holds (every stream's)."""

    def __init__(self, kernels, ranges, lo: float, hi: float, frames: int, supersteps: int):
        self.kernels = kernels
        self.ranges = ranges
        self.lo, self.hi = lo, hi
        self.frames = frames
        self.supersteps = supersteps

    @classmethod
    def from_intervals(cls, kernels, ranges=(), lo=None, hi=None, frames: int = 1, supersteps: int = 1):
        lo = min(a for _, a, _ in kernels) if lo is None else lo
        hi = max(b for _, _, b in kernels) if hi is None else hi
        return cls(list(kernels), list(ranges), lo, hi, frames, supersteps)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_seconds([(max(a, self.lo), min(b, self.hi)) for _, a, b in self.kernels if b > self.lo
                              and a < self.hi])

    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or not self.kernels:
            return None
        return 1.0 - self.busy_s / self.window_s

    def seconds_by_kernel(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for name, a, b in self.kernels:
            out[name] += b - a
        return dict(out)

    def n_kernels(self) -> int:
        """The device operations that are kernels (copies and fills aside)."""
        return sum(1 for name, _, _ in self.kernels if not is_copy(name))

    def host_label(self, t: float) -> str:
        """The innermost harness range open at ``t`` (the shortest that
        holds it, the slice's own range aside), or "harness" outside all of
        them: the harness's loop between calls into the program."""
        best, width = "harness", float("inf")
        for name, a, b in self.ranges:
            if name != "slice" and a <= t <= b and b - a < width:
                best, width = name, b - a
        return best

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each gap named by what the host was doing, ``top`` of each."""
        ops = sorted(self.seconds_by_kernel().items(), key=lambda kv: -kv[1])[:top]
        gaps = idle_gaps([(a, b) for _, a, b in self.kernels], self.lo, self.hi)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_label((a + b) / 2), b - a] for a, b in gaps]}


def from_profiler(prof, lo_name: str, frames: int, supersteps: int) -> Slice:
    """The ``Slice`` of a finished ``torch.profiler.profile``: every CUDA
    kernel, the harness's ranges (names beginning ``HOST_PREFIX``), and as
    bounds the range named ``lo_name``, which the harness opens around the
    traced dispatches."""
    import torch

    kernels, ranges = [], []
    for e in prof.events():
        t0, t1 = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name.startswith(HOST_PREFIX):  # a harness range, or its mirror on the device's timeline
            if e.device_type != torch.autograd.DeviceType.CUDA:
                ranges.append((e.name[len(HOST_PREFIX):], t0, t1))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, t0, t1))
    slices = [(a, b) for n, a, b in ranges if n == lo_name]
    if not slices:
        raise RuntimeError(f"the trace holds no range {HOST_PREFIX}{lo_name}")
    lo, hi = min(a for a, _ in slices), max(b for _, b in slices)
    return Slice(kernels, ranges, lo, hi, frames, supersteps)
