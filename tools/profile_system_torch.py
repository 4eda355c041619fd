#!/usr/bin/env python3
"""Per-stage device timing of the port's ``DeviceSystem`` superstep at KITTI
geometry, each stage in isolation through a CUDA graph: the port's
counterpart of ``tools/profile_system.py``.

Run from the repository root: ``python3 tools/profile_system_torch.py
[--device cpu]``.

Set-up, as the JAX tool's: bench.py's scene (texture seed 0, 8 frames),
``DeviceSystem(supersteps_per_chunk=1)`` with bench.py's configuration,
bootstrapped on frames 0 and 1, then one superstep (frames 2-4, through
``chunk_fn(1)``) to warm the map and the filters; frame 5 is the current
image.

The stages are what the port's frame step (``DeviceVO._frame_step``) runs,
with the inputs it gives them: one keyframe frame step on that state runs
with each stage's function wrapped, from here, to record its first call
(``record_stages``), and each stage replays that call: the pyramid
(``build_pyramid``), sparse alignment over 4 levels
(``SparseImageAlign.align_precomputed``, K1 four times), map reprojection
with feature alignment (``reproject_device``, K2), the pose polish
(``pose_refine``, K3; the JAX tool times ``optimize_pose``, which the
port's device path does not run), the depth-filter update
(``update_filters``, K4) and the windowed BA (``DeviceVO._run_ba``); then
the whole tracked frame and the whole keyframe frame (``_frame_step``), and
the amortized frame ((period − 1)·tracked + keyframe) / period.

Each stage is one CUDA graph (``pipeline.cuda_graph.GraphedCall``) of
``REPS`` (20) calls, each call's first floating-point input moved by a −0.0
computed from the call before's output (``chained``): the counterpart of
the JAX tool's ``scanned``, a serial dependency from call to call. The
graph is captured once and replayed 3 times on its own input buffers (so no
input is copied); ``ms`` is the median of CUDA events around a replay over
``REPS``, and ``kernels`` the device events of one replay by
``torch.profiler`` over ``REPS`` (the port's four kernels beside them, by
the wrappers' launch counters; ``kernel_counts``). The row ``chain alone``
is the dependency's own cost (x ↦ x on the image): about five small
kernels a call, included in every other row. Every call runs under
PyTorch's deterministic algorithms, the mode ``DeviceSystem`` ships with.

Prints a table, then one JSON line: each stage's ``ms`` and ``kernels`` a
call, the amortized frame, ``card`` (``nvidia-smi``'s name and power limit)
and ``device``. Runs on the card; ``--device cpu`` runs each stage's calls
eagerly and times them on the host clock (no kernel counts). Imports nothing
of JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20
REPLAYS = 3
PREROLL = 64  # empty kernels opening a profiled window (``kernel_counts``)
N_FRAMES = 8
CURRENT = 5  # the current image


def record_stages(vo, state, image) -> dict:
    """Each stage of ``vo._frame_step(state, image, is_kf=True)`` as the frame
    step calls it: {stage: (function, args, kwargs)} of its first call,
    recorded by wrapping the function in its module or class for one frame
    step (restored afterwards), and the two whole frame steps."""
    from sdvo_tpu_torch.align.image_alignment import SparseImageAlign
    from sdvo_tpu_torch.pipeline import device_system as D

    targets = {"pyramid": (D, "build_pyramid"), "alignment (K1 x4)": (SparseImageAlign, "align_precomputed"),
               "reprojection (K2)": (D, "reproject_device"), "pose polish (K3)": (D, "pose_refine"),
               "depth filters (K4)": (D, "update_filters"), "local BA": (D.DeviceVO, "_run_ba")}
    saved = {name: vars(ns)[attr] for name, (ns, attr) in targets.items()}
    calls = {}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            calls.setdefault(name, (fn, args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    try:
        for name, (ns, attr) in targets.items():
            setattr(ns, attr, recorder(name, saved[name]))
        vo._frame_step(state, image, is_kf=True)
    finally:
        for name, (ns, attr) in targets.items():
            setattr(ns, attr, saved[name])
    missing = set(targets) - set(calls)
    if missing:
        raise RuntimeError(f"the frame step did not call {sorted(missing)}")
    stages = {name: calls[name] for name in targets}
    stages["tracked frame"] = (type(vo)._frame_step, (vo, state, image), {"is_kf": False})
    stages["keyframe frame"] = (type(vo)._frame_step, (vo, state, image), {"is_kf": True})
    return stages


def _dependency(out):
    """A −0.0 computed from the first floating-point tensor of ``out``: added
    to a tensor it changes no bit, and it orders the next call after this
    one."""
    from sdvo_tpu_torch.pipeline.cuda_graph import flatten

    x = next(t for t in flatten(out)[0] if t.is_floating_point())
    return x.reshape(-1)[0].nan_to_num(0.0, 0.0, 0.0).mul(0.0).abs().neg()


def chained(fn, reps: int):
    """``run(args, kwargs)``: ``fn(*args, **dict(kwargs))`` ``reps`` times,
    each call's first floating-point input plus the ``_dependency`` of the
    call before's output; returns the last dependency. ``kwargs`` is a tuple
    of (name, value) pairs, so that a ``GraphedCall`` takes its tensors as
    inputs."""
    from sdvo_tpu_torch.pipeline.cuda_graph import flatten, unflatten

    def run(args, kwargs):
        leaves, spec = flatten((args, kwargs))
        first = next(i for i, x in enumerate(leaves) if x.is_floating_point())
        dep = None
        for _ in range(reps):
            moved = list(leaves)
            if dep is not None:
                moved[first] = moved[first] + dep
            a, kw = unflatten(spec, moved)
            dep = _dependency(fn(*a, **dict(kw)))
        return dep

    return run


def graph_ms(call, args, graph, replays: int = REPLAYS):
    """Device ms of each of ``replays`` calls of ``call(*args)`` after the
    first (on the card, the capture of ``graph``, a ``GraphedCall``), each
    from CUDA events around the call, with the capture's own static buffers
    as inputs so that no input is copied; on the CPU the host clock around
    each eager call. Returns (the ms of each call, a function that makes one
    more such call)."""
    import torch

    from sdvo_tpu_torch.pipeline.cuda_graph import flatten, unflatten

    leaves, spec = flatten(args)
    call(*args)
    if leaves[0].device.type != "cuda":
        ms = []
        for _ in range(replays):
            t0 = time.perf_counter()
            call(*args)
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, lambda: call(*args)
    static = unflatten(spec, graph.last.static_in)
    ms = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call(*static)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return ms, lambda: call(*static)


def kernel_counts(fn, preroll: int = PREROLL):
    """What one call ``fn()`` launches on the card: (its device events by
    ``torch.profiler``, the port's four kernels by the wrappers' counters,
    the pre-roll's events the profiler dropped). The profiled window opens
    with ``preroll`` empty kernels (``torch.cuda._sleep(0)``), not counted:
    in a long process the profiler was seen to drop the first device events
    of a window (24 in a run of ``chip_smoke.py``), and the pre-roll takes
    that loss; a window whose pre-roll shows no event raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdvo_tpu_torch.ops import build

    mods = build.kernel_modules()
    before = {k: m.launches for k, m in mods.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(preroll):
            torch.cuda._sleep(0)
        fn()
        torch.cuda.synchronize()
    own = {k: m.launches - before[k] for k, m in mods.items()}
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spins = sum("spin_kernel" in e.name for e in device)
    if not spins:
        raise RuntimeError("the profiler shows none of the pre-roll's kernels")
    return len(device) - spins, own, preroll - spins


def profile(vo, state, image, reps: int = REPS, replays: int = REPLAYS) -> list:
    """Each stage of ``record_stages`` and the chain alone, ``reps`` chained
    calls in one graph (the CPU: eagerly): rows of ``stage``, ``ms`` (the
    median a call), ``ms_replays`` (each replay's ms a call) and, on the
    card, ``kernels`` (device events a call by ``torch.profiler``), ``own``
    (the port's four kernels a call, by the wrappers' counters) and
    ``profiler_dropped`` (``kernel_counts``)."""
    from sdvo_tpu_torch.pipeline.cuda_graph import GraphedCall

    cuda = image.device.type == "cuda"
    stages = {"chain alone": (lambda x: x, (image,), {}), **record_stages(vo, state, image)}
    rows = []
    for name, (fn, args, kwargs) in stages.items():
        run = chained(fn, reps)
        call = GraphedCall(run, f"profile_system: {name}") if cuda else run
        ms, again = graph_ms(call, (args, tuple(kwargs.items())), call if cuda else None, replays)
        row = {"stage": name, "ms": float(np.median(ms)) / reps, "ms_replays": [m / reps for m in ms]}
        if cuda:
            events, own, dropped = kernel_counts(again)
            row.update(kernels=events / reps, own={k: n / reps for k, n in own.items()}, profiler_dropped=dropped)
        rows.append(row)
    return rows


def amortized(rows, period: int) -> float:
    """((period − 1)·tracked + keyframe) / period, in ms a frame."""
    ms = {r["stage"]: r["ms"] for r in rows}
    return ((period - 1) * ms["tracked frame"] + ms["keyframe frame"]) / period


def setup(frames, device):
    """The JAX tool's state: ``DeviceSystem(supersteps_per_chunk=1)`` with
    bench.py's configuration on ``device`` (None: the card), bootstrapped on frames 0 and 1,
    one superstep on frames 2-4. Returns (the system, frame 5 on the
    device)."""
    import torch

    from bench_torch import bench_config, bootstrap
    from sdvo_tpu_torch.device import deterministic_on
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    ds = DeviceSystem(bench_config(), supersteps_per_chunk=1, device=device)
    bootstrap(ds, frames)
    per = ds.scfg.period
    imgs = torch.from_numpy(np.stack(frames[2:2 + per]).astype(np.float32)[None]).to(ds.device, ds.dtype)
    with deterministic_on(ds.device):
        ds.state, _ = ds.vo.chunk_fn(1)(ds.state, imgs)
    return ds, torch.from_numpy(np.asarray(frames[CURRENT], np.float32)).to(ds.device, ds.dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu: run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from bench_torch import card_and_name
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequence
    from sdvo_tpu_torch.device import deterministic_on, resolve_device

    device = resolve_device(args.device)  # the card, or raise
    card, name = card_and_name(device)
    frames, _ = render_bench_sequence(np.random.default_rng(0), N_FRAMES)
    ds, image = setup(frames, device)
    with deterministic_on(device):
        rows = profile(ds.vo, ds.state, image)
    amort = amortized(rows, ds.scfg.period)
    clock = "device ms (CUDA events)" if card else "host ms (the CPU's clock)"
    print(f"per-stage {clock} a call, {REPS} chained calls a graph, median of {REPLAYS} replays "
          f"({card or device.type}):")
    for r in rows:
        own = " ".join(f"{k} {n:g}" for k, n in r.get("own", {}).items())
        kernels = f"{r['kernels']:9.1f} kernels  {own}" if "kernels" in r else ""
        print(f"  {r['stage']:28s} {r['ms']:9.4f} ms  {kernels}")
    print(f"  {'amortized frame':28s} {amort:9.4f} ms -> {1e3 / amort:.1f} frames/s ceiling")
    print(json.dumps({"stages": rows, "amortized_ms": amort, "reps": REPS, "card": card,
                      "device": name or device.type}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
