#!/usr/bin/env python3
"""A cell of the benchmark with the port's own tracer on.

    python3 benchmark/trace_program.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs ``run.py``'s measurement of the cell (the same set-up, window, traced
slice and check) with ``sdvo_tpu_torch.utils.timing.TRACER`` on from
before the set-up, and prints as its last line ``run.py``'s result object
with more keys:

* ``program``: each metric of ``program_metrics.json`` that the cell
  reports, read by its ``metrics/<name>.py`` from the tracer's spans and
  counters (``harness/program.py::record``) and, with ``--trace 1``, from
  the traced slice's graph replays matched to the graph's stage map;
* ``host_spans``: {span: [seconds, count]} inside the window, the traced
  slice left out, and ``spanned``: that window's seconds and frames;
* with ``--trace 1``, ``program_breakdown``: device seconds by stage inside
  the slice's replays with the unattributed rest and the attributed share
  (``stages``), the slice's idle seconds by the innermost program span
  open over them (``idle_by_span``), and its longest idle gaps so named;
  ``graphs``, the CUDA graphs the system captured, and
  ``stage_map_operations``, the length of the stage map. The map is taken
  after the window (``Capture.stage_map()``: one more eager run of the
  chunk under the profiler), and only where the system captured one graph:
  with more, a replay's graph is not known, and nothing is attributed.

In the traced slice the program's ranges are taken out of the device's
events before any reduction (the profiler mirrors them on the device's
timeline), so ``run.py``'s own metrics read as they do with the tracer off.
With ``--trace 0`` the window runs with the tracer on and no profiler: its
``frames_per_s`` and ``pose_latency_p95_ms`` against ``run.py --trace 0``
are what the tracer costs. ``run.py`` never turns the tracer on: its lines
carry none of these metrics. Exits as ``run.py`` does, and 5 where the
checkout's port has no tracer.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def entries(cell) -> list:
    """The entries of ``program_metrics.json`` (``per_layer`` entries of
    ``BENCHMARK.json``'s form) that ``cell`` reports."""
    from benchmark.harness import spec

    return [m for m in spec.load_json(os.path.join(HERE, "program_metrics.json"))["per_layer"]
            if spec.applies(m, cell.name)]


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float, tracer, fault=None,
            **kw) -> dict:
    """``run.measure`` with ``tracer`` on, the program's metrics and
    reductions added to its result (see the module's docstring)."""
    import run

    from benchmark.harness import drive, program, spec
    from benchmark.harness import trace as trace_mod

    parts, extra, systems = {}, {}, []
    from_profiler, run_record = trace_mod.from_profiler, drive.run_record

    def held(system):  # the set-up hands its system here before the warm-up dispatch
        systems.append(system)
        if fault is not None:
            fault(system)

    def traced_slice(prof, lo_name, frames, supersteps):
        parts["ranges"], parts["launches"] = program.profile_parts(prof)
        return program.without_program_ranges(from_profiler(prof, lo_name, frames, supersteps))

    def record(w, c):
        r = run_record(w, c)
        stage_map = None
        if parts.get("launches"):  # taken after the window, from the one graph the system captured
            captures = program.graph_captures(systems[0])
            extra["graphs"] = len(captures)
            if len(captures) == 1:
                stage_map = captures[0].stage_map()
                extra["stage_map_operations"] = None if stage_map is None else len(stage_map)
        r.program = p = program.record(tracer, w, parts, stage_map)
        extra["program"] = spec.read_metrics(entries(c), r)
        extra["host_spans"] = {k: list(v) for k, v in sorted(p.totals.items())}
        extra["spanned"] = {"window_s": r.window_s, "frames": r.frames}
        if p.stages is not None:
            extra["program_breakdown"] = {"stages": p.stages, "idle_by_span": p.idle,
                                          "idle_gaps": program.idle_gaps_named(w.slice, parts["ranges"])}
        return r

    trace_mod.from_profiler, drive.run_record = traced_slice, record
    try:
        with tracer.recording():
            result = run.measure(cell, seed, seconds, trace, device, t_start, fault=held, **kw)
    finally:
        trace_mod.from_profiler, drive.run_record = from_profiler, run_record
    check = result.pop("check")
    result.update(extra)
    result["check"] = check
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import run

    run._caches()
    from benchmark.harness import program, spec

    cell = spec.Cell(spec.benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"trace_program.py: {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 3
    tracer = program.tracer()
    if tracer is None:
        print("trace_program.py: the checkout's port has no tracer", file=sys.stderr)
        return 5
    print(f"card: {run.card_line()}", file=sys.stderr)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START, tracer)
    bad = run.forbidden_modules()
    if bad:
        print(f"trace_program.py: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
