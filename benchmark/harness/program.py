"""What the harness reads of the port's own tracer
(``sdvo_tpu_torch.utils.timing.TRACER``): host spans and counters kept in
the process, the program's ranges in a ``torch.profiler`` trace (names
beginning ``PREFIX``), and the stage maps the port's CUDA graphs give
(``Capture.stage_map()``).

From them, beside what ``trace.py`` reduces:

* ``profile_parts``: the program's host ranges and each CUDA graph
  launch's device operations (found by the launch's correlation id), on
  the clock of ``trace.Slice``;
* ``match_stages``: a replay's device operations against its graph's
  stage map, in order and checked by name: an operation whose name
  differs from the map's, or that lies past its end, is unattributed; the
  matcher does not guess, and where the names part it finds the place
  where they agree again;
* ``idle_by_span``: every idle stretch of a slice put down to the
  innermost program range open over it, else to the harness's range, else
  to "harness";
* ``record``: the per-layer readers' view of one window (``run.program``).

``trace.from_profiler`` counts every device-side event that is not the
harness's as a kernel, and the profiler mirrors a program range on the
device's timeline: ``without_program_ranges`` takes those mirrors out of a
slice.
"""

from __future__ import annotations

import collections
import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.harness.trace import Slice, idle_gaps

PREFIX = "sdvo/"  # the port's ranges (``sdvo_tpu_torch.utils.timing.PREFIX``)
OUTSIDE = "(outside every stage)"  # a matched operation no stage span held
FRAME_STAGES = tuple(f"device_vo.{s}" for s in ("pyramid", "align", "reproject", "pose_refine", "gate",
                                                "depth_filter"))
KEYFRAME_STAGES = tuple(f"device_vo.kf.{s}" for s in ("tables", "promote", "detect", "ba", "evict", "reference"))


def tracer():
    """The port's tracer, or None where the checkout's port has none."""
    try:
        from sdvo_tpu_torch.utils.timing import TRACER
    except ImportError:
        return None
    return TRACER


def graph_captures(system) -> list:
    """Every capture of the CUDA graphs a system's window can replay: a
    ``MultiSequenceSystem``'s joint chunk, a ``DeviceSystem``'s chunk and
    superstep."""
    joint = getattr(getattr(system, "chunk_fn", None), "graph", None)
    calls = [joint] if joint is not None else [system.vo.chunk_graph, system.vo.step_graph]
    return [c for call in calls for c in call.graphs.values()]


def profile_parts(prof) -> Tuple[List[Tuple[str, float, float]], List[Tuple[float, List[Tuple[str, float, float]]]]]:
    """(the program's host ranges [(name without the prefix, start s, end
    s)], each CUDA graph launch [(its host call's start s, its device
    operations [(name, start s, end s)] in order)]) of a finished
    ``torch.profiler.profile``, on the clock of ``trace.from_profiler``."""
    import torch

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges, launches, device = [], {}, collections.defaultdict(list)
    for e in res.events():
        name = e.name()
        a, b = (e.start_ns() - t0) * 1e-9, (e.end_ns() - t0) * 1e-9
        if e.device_type() == cpu:
            if name.startswith(PREFIX):
                ranges.append((name[len(PREFIX):], a, b))
            elif name == "cudaGraphLaunch":
                launches[e.correlation_id()] = a
        elif e.device_type() == cuda and not name.startswith(PREFIX):
            device[e.correlation_id()].append((name, a, b))
    return sorted(ranges, key=lambda r: r[1]), [(t, sorted(device.get(c, []), key=lambda k: k[1]))
                                                 for c, t in sorted(launches.items(), key=lambda kv: kv[1])]


def without_program_ranges(s: Slice) -> Slice:
    """``s`` without the device-side mirrors of the program's ranges."""
    return Slice([k for k in s.kernels if not k[0].startswith(PREFIX)], s.ranges, s.lo, s.hi, s.frames,
                 s.supersteps)


def op_class(name: str) -> str:
    """A device operation's name as the matcher compares it: every copy is
    "copy" and every fill "fill" (an eager copy between buffers may run as
    a CUDA kernel, ``memcpy32_post``, where the graph holds a copy node),
    every other operation its own name."""
    low = name.lower()
    return "copy" if low.startswith("memcpy") else "fill" if low.startswith("memset") else name


RESYNC = 8  # how far past a mismatch the matcher looks for where the replay and the map agree again
AGREE = 4  # how many operations in a row, by name, make them agree again


def _resync(got: Sequence[str], want: Sequence[str], i: int, j: int) -> Optional[Tuple[int, int]]:
    """The nearest (skip in ``got``, skip in ``want``), each under
    ``RESYNC``, past which ``AGREE`` operations (or all that are left) agree
    by name; None where there is none."""
    for total in range(1, 2 * RESYNC - 1):
        for di in range(max(0, total - RESYNC + 1), min(total, RESYNC - 1) + 1):
            dj = total - di
            n = min(AGREE, len(got) - i - di, len(want) - j - dj)
            if n > 0 and got[i + di:i + di + n] == want[j + dj:j + dj + n]:
                return di, dj
    return None


def match_stages(ops: Sequence[Tuple[str, float, float]], stage_map: Optional[Sequence[Tuple[str, str]]],
                 missed: Optional[Dict[str, float]] = None) -> Tuple[Dict[str, float], float]:
    """({stage: device seconds}, unattributed seconds) of one replay's device
    operations against its graph's stage map (see the module's docstring);
    a matched operation outside every stage goes under ``OUTSIDE``. The two
    are walked in order; where the names part (a renamed kernel, or two
    operations whose device clock reads the same start and sort the other
    way), the operations up to the nearest place where ``AGREE`` agree
    again are unattributed, and where none lies within ``RESYNC``, the
    one operation. ``missed``, where given, gains the seconds of each
    unattributed operation by its name."""
    got = [op_class(name) for name, _, _ in ops]
    want = [op_class(name) for name, _ in stage_map] if stage_map is not None else []
    by: Dict[str, float] = collections.defaultdict(float)
    lost = 0.0
    i = j = 0
    while i < len(ops):
        if j < len(want) and got[i] == want[j]:
            by[stage_map[j][1] or OUTSIDE] += ops[i][2] - ops[i][1]
            i, j = i + 1, j + 1
            continue
        di, dj = _resync(got, want, i, j) or (1, 1)
        for name, a, b in ops[i:i + di]:
            lost += b - a
            if missed is not None:
                missed[name] = missed.get(name, 0.0) + b - a
        i, j = i + di, j + dj
    return dict(by), lost


def _innermost(ranges, t: float) -> Optional[str]:
    best, width = None, math.inf
    for name, a, b in ranges:
        if a <= t <= b and b - a < width:
            best, width = name, b - a
    return best


def replay_stages(launches, stage_map: Optional[Sequence[Tuple[str, str]]]) -> Optional[dict]:
    """Device seconds by stage over every graph launch of a slice, each
    matched to ``stage_map``, the map of the one graph the window replays
    (None where there is none: nothing is attributed). Returns ``seconds``
    by stage, ``unattributed`` and ``total`` seconds, ``replays``,
    ``attributed`` (the named stages' share of the total) and ``unmatched``
    (the five names with the most unattributed seconds), or None without a
    launch."""
    if not launches:
        return None
    by: Dict[str, float] = collections.defaultdict(float)
    missed: Dict[str, float] = {}
    lost = total = 0.0
    for _, ops in launches:
        got, miss = match_stages(ops, stage_map, missed)
        for stage, sec in got.items():
            by[stage] += sec
        lost += miss
        total += math.fsum(b - a for _, a, b in ops)
    named = math.fsum(sec for stage, sec in by.items() if stage != OUTSIDE)
    return {"seconds": dict(by), "unattributed": lost, "total": total, "replays": len(launches),
            "attributed": named / total if total > 0 else None,
            "unmatched": sorted(missed.items(), key=lambda kv: -kv[1])[:5]}


def idle_by_span(s: Slice, ranges) -> Dict[str, float]:
    """The idle seconds of slice ``s`` (every gap, not the longest alone) by
    the innermost program range open over them, else by the harness's
    range (``Slice.host_label``), else "harness"."""
    inside = [(n, a, b) for n, a, b in ranges if b > s.lo and a < s.hi]
    edges = {x for _, a, b in inside + list(s.ranges) for x in (a, b)}
    out: Dict[str, float] = collections.defaultdict(float)
    for lo, hi in idle_gaps([(a, b) for _, a, b in s.kernels], s.lo, s.hi):
        cuts = sorted({lo, hi} | {x for x in edges if lo < x < hi})
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            out[_innermost(inside, mid) or s.host_label(mid)] += b - a
    return dict(out)


def idle_gaps_named(s: Slice, ranges, top: int = 10) -> List[list]:
    """The ``top`` longest idle gaps of ``s``, each named by the innermost
    program range open at its middle, else as ``Slice.breakdown`` names it."""
    gaps = sorted(idle_gaps([(a, b) for _, a, b in s.kernels], s.lo, s.hi), key=lambda g: g[0] - g[1])[:top]
    return [[_innermost(ranges, 0.5 * (a + b)) or s.host_label(0.5 * (a + b)), b - a] for a, b in gaps]


def record(tr, w, parts: dict, stage_map=None) -> SimpleNamespace:
    """``run.program`` of a window ``w`` (``drive.Window``) from the tracer
    ``tr`` and, for a traced run, ``parts`` (``profile_parts`` of its slice,
    under ``ranges`` and ``launches``) and ``stage_map`` (the map of the one
    graph the window replays, or None): ``totals`` {span: (seconds, count)}
    inside the window and outside the traced slice, ``setup`` the same
    before the window, ``counters`` added inside the window, ``warmup_s``
    (the last ``graph.warmup`` before the window: the capture of the graph
    the window replays, made by the set-up's warm-up dispatch), ``stages``
    (``replay_stages`` of the slice) and ``idle`` (``idle_by_span``)."""
    spans = [s for s in tr.spans if s is not None]
    totals: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    setup: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for s in spans:
        into = (totals if w.t0 <= s.start and s.end <= w.t_end and not s.profiled
                else setup if s.end <= w.t0 else None)
        if into is not None:
            into[s.name][0] += s.end - s.start
            into[s.name][1] += 1
    counters: Dict[str, float] = collections.defaultdict(float)
    for t, name, value in tr.counts:
        if w.t0 <= t <= w.t_end:
            counters[name] += value
    warm = [s.end - s.start for s in spans if s.name == "graph.warmup" and s.end <= w.t0]
    stages = idle = None
    if parts.get("launches") is not None and w.slice is not None:
        stages = replay_stages(parts["launches"], stage_map)
        idle = idle_by_span(w.slice, parts["ranges"])
    return SimpleNamespace(totals={k: tuple(v) for k, v in totals.items()},
                           setup={k: tuple(v) for k, v in setup.items()}, counters=dict(counters),
                           warmup_s=warm[-1] if warm else None, stages=stages, idle=idle)


# ------------------------------------------------------------- the readers
def program(run) -> Optional[SimpleNamespace]:
    return getattr(run, "program", None)


def span_ms_per_frame(run, span: str, system: str) -> Optional[float]:
    """Σ ``span`` in the window, outside the traced slice, in ms a frame of
    every stream (None where the run has no such span)."""
    p = program(run)
    if p is None or run.system != system or run.frames <= 0 or span not in p.totals:
        return None
    return 1e3 * p.totals[span][0] / run.frames


def stage_ms(run, stages: Sequence[str], per: str) -> Optional[float]:
    """The device ms of ``stages`` in the traced slice's replays, a frame
    (``per`` "frame") or a keyframe step ("keyframe": a superstep of every
    stream)."""
    p = program(run)
    s = run.slice
    if p is None or s is None or p.stages is None:
        return None
    n = s.frames if per == "frame" else s.supersteps
    sec = [p.stages["seconds"][k] for k in stages if k in p.stages["seconds"]]
    if n <= 0 or not sec:
        return None
    return 1e3 * math.fsum(sec) / n


def ratio(run, num: str, den: str) -> Optional[float]:
    """``num`` / ``den`` of the counters added in the window."""
    p = program(run)
    if p is None or not p.counters.get(den):
        return None
    return p.counters.get(num, 0.0) / p.counters[den]
