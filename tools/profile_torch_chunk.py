#!/usr/bin/env python3
"""Where one chunk of the PyTorch port's ``DeviceSystem`` spends its time, on
a CUDA card.

Run from the repository root: ``python3 tools/profile_torch_chunk.py
[--seqs S]``. On bench.py's scene (as ``chip_smoke.py``), it bootstraps,
runs one warm-up chunk of 8 supersteps, then profiles one chunk with
``torch.profiler`` (CPU and CUDA activities). With ``--seqs S`` the chunk is
``MultiSequenceSystem``'s joint chunk over S sequences (the first S texture
seeds of ``chip_smoke.MULTI_SEEDS``), one vmapped superstep a step: its
numbers are per frame step, which is one frame of every sequence. Each stage
of the frame step is wrapped in a ``record_function`` label from here, so the port's code
carries no instrumentation. Prints the chunk's wall time, the summed kernel
time, the device idle share (1 − kernel time / wall time; one stream, so
kernels do not overlap), kernel launches per frame, per-stage host and
device time, the top kernels by device time, the port's own four kernels
(launches and mean device time on the chunk's own data), and one JSON line.
Imports nothing of JAX; fails without a card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import MULTI_SEEDS  # noqa: E402
from sdvo_tpu_torch.config import load_config  # noqa: E402
from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences  # noqa: E402
from sdvo_tpu_torch.parallel import MultiSequenceSystem  # noqa: E402
from sdvo_tpu_torch.pipeline import device_system as D  # noqa: E402
from sdvo_tpu_torch.align import image_alignment  # noqa: E402
from sdvo_tpu_torch.ops import selfcheck  # noqa: E402

SUPERSTEPS = 8
PER = 3
STAGES = {  # label: (namespace, attribute) called once per frame or keyframe
    "pyramid": (D, "build_pyramid"),
    "align (K1)": (image_alignment.SparseImageAlign, "align_precomputed"),
    "reproject (K2)": (D, "reproject_device"),
    "pose polish (K3)": (D, "pose_refine"),
    "depth filters (K4)": (D, "update_filters"),
    "keyframe step": (D.DeviceVO, "_keyframe_step"),
}


OWN_KERNELS = {"K1": "lm_align_level_kernel", "K2": "fa_align_kernel", "K3": "pose_refine_kernel",
               "K4": "depth_scores_kernel"}


def _label(name, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _drives(config, seqs, multi: bool):
    """(warm-up, the profiled chunk, every frame's metrics) over the rendered
    sequences: ``DeviceSystem`` on the one sequence, or
    ``MultiSequenceSystem`` on all of them."""
    chunk = SUPERSTEPS * PER
    if not multi:
        ds = D.DeviceSystem(config, supersteps_per_chunk=SUPERSTEPS)
        frames = seqs[0]

        def track(start, stop):
            for i in range(start, stop):
                ds.add_image(frames[i], float(i))

        return (lambda: track(0, 2 + chunk)), (lambda: track(2 + chunk, 2 + 2 * chunk)), lambda: ds.metrics
    ms = MultiSequenceSystem(config, len(seqs), supersteps_per_chunk=SUPERSTEPS)

    def warm():
        ms.bootstrap(seqs)
        ms.joint([s[:2 + chunk] for s in seqs])

    return warm, (lambda: ms.joint(seqs)), lambda: [m for sub in ms.subs for m in sub.metrics]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seqs", type=int, default=None,
                    help="profile MultiSequenceSystem's joint chunk over this many sequences")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_chunk: no CUDA device", file=sys.stderr)
        return 1
    for name, (ns, attr) in STAGES.items():
        setattr(ns, attr, _label(name, getattr(ns, attr)))
    chunk = SUPERSTEPS * PER
    n_seq = args.seqs or 1
    if n_seq > len(MULTI_SEEDS):
        raise ValueError(f"--seqs up to {len(MULTI_SEEDS)}: the tracked seeds are {MULTI_SEEDS}")
    seqs = [r[0] for r in render_bench_sequences(MULTI_SEEDS[:n_seq], 2 + 2 * chunk)]
    config = load_config(overrides={
        "initialization": {"disparity_threshold": 3, "threshold_gradient_magnitude": 20}})
    warm, profiled, metrics = _drives(config, seqs, multi=args.seqs is not None)
    warm()  # bootstrap + warm-up chunk
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        profiled()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if any(m["result"] == "FAILED" for m in metrics()):
        raise RuntimeError("tracking failed")
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.events()
    # record_function ranges appear twice: on the host, and as a span on the
    # device timeline; the rest of the device events are kernels and copies
    spans = [e for e in events if e.device_type == cuda and e.key in STAGES]
    kernels = [e for e in events if e.device_type == cuda and e.key not in STAGES
               and e.key != "Activity Buffer Request"]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    card = selfcheck.card_line()
    what = "DeviceSystem" if args.seqs is None else f"MultiSequenceSystem, S = {n_seq}, a frame step is one frame of each"
    print(f"chunk of {chunk} frame steps ({what}) on {card} (under the profiler): wall {wall_ms:.1f} ms "
          f"({wall_ms / chunk:.2f} ms/frame step, {n_seq * chunk * 1e3 / wall_ms:.1f} frames/s), "
          f"kernel time {busy_ms:.1f} ms, device idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(kernels) / chunk:.0f} device events/frame step")
    for name in STAGES:
        host = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == cpu and e.key == name) / 1e3
        own = [(e.time_range.start, e.time_range.end) for e in spans if e.key == name]
        inside = [e for e in kernels if any(a <= e.time_range.start < b for a, b in own)]
        dev = sum(e.time_range.elapsed_us() for e in inside) / 1e3
        print(f"  stage {name:20s} host {host / chunk:7.3f} ms/frame step, kernels {dev / chunk:7.3f} "
              f"ms/frame step in {len(inside) / chunk:6.1f} launches/frame step")
    averages = prof.key_averages()
    top = sorted((a for a in averages if a.key not in STAGES
                  and a.self_device_time_total > 0), key=lambda a: -a.self_device_time_total)
    for a in top[:12]:
        print(f"  kernel {a.key[:60]:60s} {a.count:6d} x  {a.self_device_time_total / 1e3:8.2f} ms")
    own = {}
    for label, stem in OWN_KERNELS.items():
        hits = [a for a in averages if stem in a.key]
        count = sum(a.count for a in hits)
        total = sum(a.self_device_time_total for a in hits) / 1e3
        own[label] = {"launches": count, "mean_ms": total / max(count, 1)}
        print(f"  own kernel {label} ({stem}): {count} launches ({count / chunk:.2f} a frame step), "
              f"{total:.3f} ms, {total / max(count, 1):.5f} ms a launch")
    print(json.dumps({"seqs": n_seq, "wall_ms": wall_ms, "own_kernels": own, "kernel_ms": busy_ms,
                      "frame_steps": chunk, "device_idle_share": 1 - busy_ms / wall_ms,
                      "device_events_per_frame_step": len(kernels) / chunk, "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
