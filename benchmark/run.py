#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``sdvo_tpu_torch``) on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell named in ``BENCHMARK.json`` (its configuration from
``benchmark/configs/``, its traffic from ``benchmark/workloads/``): the scene
from ``--seed`` rendered on the card, the port's system set up, bootstrapped
and warmed (one dispatch: the CUDA graph's capture), then ``--seconds`` of
frames through the product path (``benchmark/harness/drive.py``). After
the window it checks the outputs against the plain reference
(``benchmark/harness/check.py``) and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and with ``--trace 1`` ``breakdown``), and last
``check``, each compared number beside its limit; the same numbers end
standard error. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled slice of the window.

Without a CUDA card, or with fewer cards than the cell asks for, it exits 3
and prints no result; it never runs on the CPU. It exits 4 if the JAX
package or JAX is loaded in the process once the window has closed.
Build and kernel caches stay in the checkout's ``build/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sdvo_tpu")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in (sys.modules if modules is None else modules) if m.split(".")[0] in FORBIDDEN)


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def quarter_rates(w) -> list:
    """Frames a second in each quarter of the window, from the dispatches'
    returns (a dispatch counts in the quarter it returns in)."""
    edges = [w.t0 + (w.t_end - w.t0) * q / 4 for q in range(5)]
    done = [0] + [max([n for t, n in w.marks if t <= e] or [0]) for e in edges[1:]]
    return [(done[q + 1] - done[q]) / (edges[q + 1] - edges[q]) for q in range(4)]


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float, cam=None,
            texture_size=None, fault=None, log=print) -> dict:
    """One run of ``cell``: the window, the metrics, the check, at the camera
    and in the scene of its configuration's file (``cam``/``texture_size``:
    the CPU rehearsal's smaller ones). Returns the result object (the last
    line's)."""
    import numpy as np
    import torch

    from benchmark import scene as scene_mod
    from benchmark.harness import check, drive, gates, spec

    w = drive.run_window(cell, seed, seconds, trace, device, cam=cam, texture_size=texture_size, fault=fault)
    setup_s = w.t0 - t_start
    window_s = w.t_end - w.t0
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = drive.run_record(w, cell)
    for k, (a, b) in enumerate(w.window_frames):
        acc = gates.accuracy(w.trajectories[k][:b], [w.rings[k].truth(j) for j in range(b)])
        log(f"stream {k}: frames 0-{b - 1}, window {a}-{b - 1}, failed {acc['failed']}, ATE {acc['ate_m']} over "
            f"{acc['path_m']} (drift {acc['drift']})", file=sys.stderr)
    lat_ms = [1e3 * s for s in w.latency_s]
    log(f"window {window_s:.4f} s, {w.frames} frames, {w.supersteps} supersteps, {len(lat_ms)} dispatches "
        f"(p50 {np.percentile(lat_ms, 50):.4f} ms, p95 {np.percentile(lat_ms, 95):.4f} ms); setup "
        f"{setup_s:.4f} s, capture {w.capture_s}", file=sys.stderr)
    log("frames a second in each quarter of the window: " + ", ".join(f"{r:.4f}" for r in quarter_rates(w)) +
        f"; collector passes by generation {w.gc.count}, {[round(x, 4) for x in w.gc.seconds]} s", file=sys.stderr)
    values = {"frames_per_s": w.frames / window_s, "pose_latency_p95_ms": float(np.percentile(lat_ms, 95)),
              "setup_s": setup_s}
    if trace:
        metrics = spec.read_metrics(cell.per_layer, run)
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    name = torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and w.slice is not None:
        dev["busy_s"] = w.slice.busy_s
        dev["window_s"] = w.slice.window_s

    # the check, once the program's state is freed
    cmp = check.Compared(w, cell.traffic, seed)
    failed = int(cmp.window["failed_frames"])
    result = {"correct": False, "attempted": w.frames, "failed": failed, "metrics": metrics, "device": dev}
    if trace and w.slice is not None:
        result["breakdown"] = w.slice.breakdown()
    del w, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = check.Reference(cell.config["settings"], cam or scene_mod.camera(cell.config["camera"]), device,
                          package=cell.reference)
    nums = check.readings(cmp, ref)
    judged = check.judge(nums, check.limits(cell))
    log("not compared: " + ", ".join(f"{k} {nums[k]!r}" for k in check.INFO), file=sys.stderr)
    result["correct"] = check.correct(judged, len(cmp.steps))
    log(f"check: {len(cmp.steps)} supersteps from sampled dispatches, {len(cmp.starts)} starts, "
        f"{time.perf_counter() - t:.2f} s", file=sys.stderr)
    result["check"] = judged
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    from benchmark.harness import spec

    cell = spec.Cell(spec.benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 3
    try:
        import sdvo_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"run.py: the port is not in this checkout: {err}", file=sys.stderr)
        return 5
    print(f"card: {card_line()}", file=sys.stderr)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    for k, v in result["check"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
