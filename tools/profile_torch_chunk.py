#!/usr/bin/env python3
"""Where one chunk of the PyTorch port's ``DeviceSystem`` spends its time, on
a CUDA card.

Run from the repository root: ``python3 tools/profile_torch_chunk.py``.
On bench.py's scene (as ``chip_smoke.py``), it bootstraps,
runs one warm-up chunk of 8 supersteps, then profiles one chunk with
``torch.profiler`` (CPU and CUDA activities). Each stage of the frame step
is wrapped in a ``record_function`` label from here, so the port's code
carries no instrumentation. Prints the chunk's wall time, the summed kernel
time, the device idle share (1 − kernel time / wall time; one stream, so
kernels do not overlap), kernel launches per frame, per-stage host and
device time, the top kernels by device time, the port's own four kernels
(launches and mean device time on the chunk's own data), and one JSON line.
Imports nothing of JAX; fails without a card.
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sdvo_tpu_torch.config import load_config  # noqa: E402
from sdvo_tpu_torch.dataio.synthetic import render_bench_sequence  # noqa: E402
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_chunk: no CUDA device", file=sys.stderr)
        return 1
    for name, (ns, attr) in STAGES.items():
        setattr(ns, attr, _label(name, getattr(ns, attr)))
    chunk = SUPERSTEPS * PER
    frames, _ = render_bench_sequence(np.random.default_rng(0), 2 + 2 * chunk)
    config = load_config(overrides={
        "initialization": {"disparity_threshold": 3, "threshold_gradient_magnitude": 20}})
    ds = D.DeviceSystem(config, supersteps_per_chunk=SUPERSTEPS)
    for i in range(2 + chunk):  # bootstrap + warm-up chunk
        ds.add_image(frames[i].astype(np.float32), float(i))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(2 + chunk, 2 + 2 * chunk):
            ds.add_image(frames[i].astype(np.float32), float(i))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if any(m["result"] == "FAILED" for m in ds.metrics):
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
    print(f"chunk of {chunk} frames on {card} (under the profiler): wall {wall_ms:.1f} ms "
          f"({wall_ms / chunk:.2f} ms/frame), kernel time {busy_ms:.1f} ms, device idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {len(kernels) / chunk:.0f} device events/frame")
    for name in STAGES:
        host = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == cpu and e.key == name) / 1e3
        own = [(e.time_range.start, e.time_range.end) for e in spans if e.key == name]
        inside = [e for e in kernels if any(a <= e.time_range.start < b for a, b in own)]
        dev = sum(e.time_range.elapsed_us() for e in inside) / 1e3
        print(f"  stage {name:20s} host {host / chunk:7.3f} ms/frame, kernels {dev / chunk:7.3f} "
              f"ms/frame in {len(inside) / chunk:6.1f} launches/frame")
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
        print(f"  own kernel {label} ({stem}): {count} launches, {total:.3f} ms, "
              f"{total / max(count, 1):.5f} ms a launch")
    print(json.dumps({"wall_ms": wall_ms, "own_kernels": own, "kernel_ms": busy_ms, "frames": chunk,
                      "device_events_per_frame": len(kernels) / chunk, "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
