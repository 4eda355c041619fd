#!/usr/bin/env python3
"""Real-motion chunk ablations of the port's ``DeviceSystem`` superstep,
through CUDA graphs: the port's counterpart of ``tools/profile_ablate.py``.

Run from the repository root: ``python3 tools/profile_ablate_torch.py
[--device cpu]``.

A stage timed alone on one frame (``profile_system_torch.py``) sees each
data-dependent LM loop at its own exit; this tool times real chunks of
distinct moving frames on a mature state, then times them again with one
stage at a time stubbed out, so that each delta is that stage's cost under
real motion. As the JAX tool: bench.py's scene (texture seed 0), chunks of 8
supersteps, 2 + 4·24 frames; ``DeviceSystem`` bootstrapped on frames 0 and
1, two chunks to mature the state, then chunk 2 from that state, through
``chunk_fn(8)``: the full chunk, and each ablation (``ABLATIONS``) on a
fresh ``DeviceVO`` (its own graph) with the port's method or module
function replaced by a stub from here while it is captured and timed
(``stubbed``: restored in a ``finally``; the package holds no switch):

* no BA: ``DeviceVO._run_ba`` returns the map and the new keyframe's pose;
* no keyframe extras: ``DeviceVO._keyframe_step`` returns the state as is;
* no alignment: ``SparseImageAlign.align_precomputed`` returns its initial
  pose (the constant-velocity seed);
* no depth filters: ``update_filters`` returns the bank, nothing converged;
* no reprojection/FA/pose: ``reproject_device`` returns the map and
  ``max_matches`` fixed matches (the JAX tool's stub), and ``pose_refine``
  its initial pose.

Each is timed as the median of 3 calls of ``chunk_fn(8)`` after the
capture, from CUDA events around the call on the graph's own input buffers
(``profile_system_torch.graph_ms``), in PyTorch's deterministic mode, the
mode ``DeviceSystem`` ships with. Prints each run's ms a frame, its delta
from the full chunk and its device kernels a frame by ``torch.profiler``
(the port's four kernels beside them, by the wrappers' launch counters), then one JSON line with
``card`` (``nvidia-smi``'s name and power limit) and ``device``. Runs on the
card; ``--device cpu`` runs the chunks eagerly on the host clock. Imports
nothing of JAX.
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERSTEPS = 8
N_CHUNKS = 4  # two to mature the state, the timed one, one more (the JAX tool's length)
REPLAYS = 3


def _no_ba(self, m, new_slot, frozen):
    from sdvo_tpu_torch.geometry.se3 import SE3
    from sdvo_tpu_torch.pipeline.device_system import take

    return m, SE3(take(m.kf_R, new_slot), take(m.kf_t, new_slot)), frozen & False


def _no_keyframe(self, state, pyr, T_cur_w, matches):
    return state, T_cur_w, state.failed & False


def _no_alignment(self, T_init, tables, cur_pyramid, feats, fx, fy, cx, cy):
    import torch

    dev = T_init.translation.device
    return (T_init, torch.full((), 0.5, dtype=T_init.translation.dtype, device=dev),
            torch.zeros((len(cur_pyramid),), dtype=torch.int32, device=dev))


def _no_filters(bank, *args, **kwargs):
    import torch

    return bank, torch.zeros(bank.mu.shape, dtype=torch.bool, device=bank.mu.device)


def _no_reprojection(m, T_cur_w, cur_gradient, fx, fy, cx, cy, *, max_matches, **kwargs):
    import torch

    from sdvo_tpu_torch.mapping.device_map import DeviceMatches

    dev, M = m.pt_pos.device, max_matches
    return m, DeviceMatches(
        pt_slot=torch.zeros((M,), dtype=torch.int64, device=dev),
        uv=torch.full((M, 2), 50.0, dtype=torch.float32, device=dev),
        err=torch.zeros((M,), dtype=torch.float32, device=dev),
        good=torch.ones((M,), dtype=torch.bool, device=dev),
        n_good=torch.full((), M, dtype=torch.int32, device=dev))


def _no_pose(T_init, points_w, bearings, valid, **kwargs):
    import torch

    return T_init, None, torch.zeros((), dtype=torch.int32, device=T_init.translation.device)


def ablations():
    """{name: [(namespace, attribute, stub)]}: each ablation's stubs."""
    from sdvo_tpu_torch.align.image_alignment import SparseImageAlign
    from sdvo_tpu_torch.pipeline import device_system as D

    return {
        "no BA": [(D.DeviceVO, "_run_ba", _no_ba)],
        "no keyframe extras": [(D.DeviceVO, "_keyframe_step", _no_keyframe)],
        "no alignment": [(SparseImageAlign, "align_precomputed", _no_alignment)],
        "no depth filters": [(D, "update_filters", _no_filters)],
        "no reprojection/FA/pose": [(D, "reproject_device", _no_reprojection), (D, "pose_refine", _no_pose)],
    }


@contextlib.contextmanager
def stubbed(targets):
    """Each (namespace, attribute, stub) of ``targets`` in place inside the
    block; the originals back in a ``finally``."""
    saved = [(ns, attr, vars(ns)[attr]) for ns, attr, _ in targets]
    try:
        for ns, attr, stub in targets:
            setattr(ns, attr, stub)
        yield
    finally:
        for ns, attr, fn in saved:
            setattr(ns, attr, fn)


def time_chunk(vo, state, images, supersteps: int, replays: int = REPLAYS) -> dict:
    """``vo.chunk_fn(supersteps)`` on (state, images): the capture, then
    ``replays`` timed calls (``profile_system_torch.graph_ms``). Returns
    ``ms_frame`` (the median ms a frame), ``ms_calls`` and, on the card,
    ``kernels_frame`` (device events a frame by ``torch.profiler``),
    ``own_frame`` (the port's four kernels a frame, by the wrappers'
    counters) and ``profiler_dropped`` (``profile_system_torch.kernel_counts``)."""
    from profile_system_torch import graph_ms, kernel_counts

    frames = images.shape[0] * images.shape[1]
    ms, again = graph_ms(vo.chunk_fn(supersteps), (state, images), vo.chunk_graph, replays)
    row = {"ms_frame": float(np.median(ms)) / frames, "ms_calls": ms}
    if images.device.type == "cuda":
        events, own, dropped = kernel_counts(again)
        row.update(kernels_frame=events / frames, own_frame={k: n / frames for k, n in own.items()},
                   profiler_dropped=dropped)
    return row


def run_ablations(vo, state, images, supersteps: int, replays: int = REPLAYS) -> list:
    """The full chunk on ``vo``, then each ablation on a fresh ``DeviceVO``
    like it, from ``state`` on ``images`` ((supersteps, period, H, W)):
    rows of ``run``, ``ms_frame``, ``delta_ms_frame`` (the full chunk's
    ms a frame minus this run's) and ``time_chunk``'s counts."""
    from sdvo_tpu_torch.pipeline.device_system import DeviceVO

    rows = [{"run": "full chunk", **time_chunk(vo, state, images, supersteps, replays)}]
    for name, targets in ablations().items():
        with stubbed(targets):
            fresh = DeviceVO(vo.cam, vo.cfg, align_settings=vo.aligner.settings, dtype=vo.dtype,
                             chunk_supersteps=supersteps)
            rows.append({"run": name, **time_chunk(fresh, state, images, supersteps, replays)})
    for r in rows:
        r["delta_ms_frame"] = rows[0]["ms_frame"] - r["ms_frame"]
    return rows


def setup(frames, device, supersteps: int = SUPERSTEPS):
    """``DeviceSystem`` with bench.py's configuration and chunks of
    ``supersteps`` on ``device`` (None: the card), bootstrapped on frames 0 and 1, and the
    chunks after them staged on the device; the first two run through
    ``chunk_fn``. Returns (the system, its state after them, the third
    chunk)."""
    import torch

    from bench_torch import bench_config, bootstrap
    from sdvo_tpu_torch.device import deterministic_on
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    ds = DeviceSystem(bench_config(), supersteps_per_chunk=supersteps, device=device)
    bootstrap(ds, frames)
    per = ds.scfg.period
    n = supersteps * per
    H, W = np.shape(frames[0])
    chunks = [torch.from_numpy(np.stack(frames[2 + c * n:2 + (c + 1) * n]).astype(np.float32))
              .to(ds.device, ds.dtype).reshape(supersteps, per, H, W) for c in range(3)]
    fn = ds.vo.chunk_fn(supersteps)
    state = ds.state
    with deterministic_on(ds.device):
        for ch in chunks[:2]:
            state, out = fn(state, ch)
            if not bool(out.ok.all()):
                raise RuntimeError("tracking failed while the state matured")
    return ds, state, chunks[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu: run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from bench_torch import PER, card_and_name
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences
    from sdvo_tpu_torch.device import deterministic_on, resolve_device

    device = resolve_device(args.device)  # the card, or raise
    card, name = card_and_name(device)
    ((frames, _),) = render_bench_sequences((0,), 2 + N_CHUNKS * SUPERSTEPS * PER, processes=os.cpu_count() or 1)
    ds, state, chunk = setup(frames, device)
    with deterministic_on(device):
        rows = run_ablations(ds.vo, state, chunk, SUPERSTEPS)
    clock = "device ms (CUDA events)" if card else "host ms (the CPU's clock)"
    print(f"chunks of {SUPERSTEPS} supersteps, chunk 2 from the matured state, {clock}, median of {REPLAYS} "
          f"calls after the capture ({card or device.type}):")
    for r in rows:
        own = " ".join(f"{k} {n:g}" for k, n in r.get("own_frame", {}).items())
        kernels = f"{r['kernels_frame']:8.1f} kernels/frame  {own}" if "kernels_frame" in r else ""
        print(f"  {r['run']:26s} {r['ms_frame']:8.4f} ms/frame (delta {r['delta_ms_frame']:+8.4f})  {kernels}")
    print(json.dumps({"runs": rows, "supersteps": SUPERSTEPS, "card": card, "device": name or device.type}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
