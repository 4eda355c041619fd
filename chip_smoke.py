#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sdvo_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Requires a CUDA card and prints its name and power limit.
2. Builds the hand-written kernels from ``sdvo_tpu_torch/csrc`` (nvcc, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K1: 256 features at all four levels, and the host
   path's 512 features at 12 iterations a level; K2: 150; K3: 150; K4: 512
   filters × 16 steps, one reference patch a filter; and K4 at the extra
   shapes of ``selfcheck.depth_extra_problems`` and K1 with
   ``freeze_sigma`` at the main path's shape (``selfcheck.freeze_problems``),
   rows of their own, which no path runs: their rows say ``"on_path": false``
   and 0 launches) and
   times both: the wrapper on the host clock, the kernel
   alone on the device with its inputs warm in the L2 cache (beside an empty
   kernel), the least time the card could take for the same work
   (``selfcheck.bound_ms``), and, where that bound is one of bytes above the
   empty kernel's time, the kernel's time with its inputs in device memory.
   Then K1, K2 and K3 against their plain versions at the extra shapes of
   ``selfcheck.extra_problems`` (correctness only).
4. Drives ``DeviceSystem`` (on its default device, the card, in the mode it
   ships with: deterministic algorithms, each chunk a replay of its CUDA
   graph) — bootstrap plus chunks of 8 supersteps — on the
   rendered 1241×376 scene of ``bench.py`` with its overrides, asserts its
   accuracy gates (no failed frame, exact keyframe cadence, scale-aligned
   ATE < 0.10 m, drift < 1.5 %), that every kernel launched during that run,
   that one chunk graph replayed once a chunk with K1 four launches a frame
   and K2–K4 one, and that no plain version ran on a CUDA tensor; prints
   frames/s, the graph's capture seconds and pool bytes and a digest of the
   trajectory. Then one more replay of that run's own chunk graph, every
   count set to 0 just before (``check_replay``): its launches, counted and
   by ``torch.profiler``, are 96/24/24/24, and another replay makes no host
   sync. Then bench.py's own protocol (``run_bench_protocol``, through
   ``bench_torch.run_protocol``): texture 0
   at bench.py's full length (2 + 504 frames; the other phases take its
   first 74) through ``DeviceSystem(supersteps_per_chunk=24)``, bootstrapped
   by ``add_image``, its 7 chunks staged on the card, then
   ``ds.vo.chunk_fn(24)``: a warm-up chunk (the capture) and 2 groups of 3
   timed chunks, each with a host copy of its outputs; bench.py's gates (no
   failed frame, 168 keyframes, ATE < 0.10 m, drift < 1.5 %), the first
   chunk's 72 frames bit for bit the main path's, and one more replay
   launching 288/72/72/72 with no host sync; prints the capture's seconds
   and pool bytes, each timed chunk's seconds and frames/s a group. Then
   (``run_graph_checks``), from one bootstrapped state:
   two graphed chunks and a one-superstep tail bit for bit the eager loop's,
   no aliasing of a chunk's outputs by the next replay, and host ms,
   device-busy ms and idle share a frame, eager against graph. After step 7 the main path runs again as the eager loop
   (``DeviceVO.run_chunk_eager``) and once more graphed: all three must give
   the same trajectory bits.
5. Drives the per-frame host ``System`` on the card over 2 + 24 frames of the
   same scene with the same gates, and asserts that K1 launched four times a
   frame, K2 and K4 launched, K3 did not (this path polishes with
   ``optimize_pose``), no plain version ran on a CUDA tensor and the windowed
   BA solved on a keyframe; prints its frames/s and ``Timers`` report.
6. Checkpoint: saves that ``System``, loads the file into a fresh one and
   tracks three more frames.
7. Failure and recovery: ``DeviceSystem`` on the same scene with one
   superstep of black frames: those frames fail with no pose, the host path
   takes over and relocalizes, ``_pack`` puts the state back on the card and
   two more chunks are tracked there, replays of the chunk graph captured
   before the blackout; the same sequence on the CPU gives the same result
   for every frame.
   Then the JAX package's long run (``run_long``): ``DeviceSystem`` with
   ``tests/test_long_sequence.py``'s configuration (320×240, chunks of 4
   supersteps) over its 300 frames with a blackout at 150–158, every gate
   of that test at its thresholds, the relocalization re-packed into the
   chunk graph captured before the blackout (its replays counted), two runs
   with one digest. Then BASELINE config 2 (``run_euroc``): ``System`` at
   752×480 and 5 levels over ``tests/test_euroc.py``'s 10 frames with its
   gates and K1 five launches a frame, and ``DeviceSystem`` at the same
   preset over 2 + 24 frames: no failed frame, exact keyframe cadence, K1
   at 4/4/6/8/10 iterations (levels 0–4), five launches a frame, the chunk
   graph captured at 5 levels, two runs with one digest.
8. The batched kernels: each kernel's one launch for ``BATCH`` = 8 stacked
   problems (``selfcheck.batched_problems``, through ``torch.func.vmap`` of
   its wrapper) against its plain version one problem at a time, and timed
   beside the one-problem launch of step 3.
9. The multi-sequence path: ``MultiSequenceSystem`` (the card by default)
   over ``BATCH`` sequences of the same scene (texture seeds
   ``MULTI_SEEDS``, rendered before any timing; sequence 0 is the main
   path's), chunks of 8 supersteps: every sequence
   passes the main path's gates, sequence 0 gives the main path's result
   for every frame with camera centres within 2 % of the path length, and
   over the joint chunks K1 launched four times a frame step and K2, K3, K4
   once (for all sequences together; launches of the joint graph's
   capture warm-up apart), no plain version ran on a CUDA tensor
   and vmap fell back to a loop for none of the four ops; the same
   sequences with the joint chunks as the eager loop give the same bits.
   Prints aggregate and per-sequence frames/s at S = 8, graphed and eager,
   and at S = 1 (two timed chunks after one warm-up), beside the main
   path's, and a joint chunk's host ms, device-busy ms and idle share.
10. Isolation: sequence 0 of a batch of two gets the same bits beside
   another texture, and, bootstrapped once, the same outputs and state
   bits from the joint chunks in the other slot.
11. The ``shard`` axis (``run_shard_axis``): the distributed Schur BA at
   the SCALING_MP.json workload (16 keyframes, 32,768 points, 4
   observations a point, 4 LM iterations, float32) with 1 and 4 in-process
   shards on the card: 4 against 1, two 4-shard runs bit for bit, chi² not
   increasing, the card against the CPU in float64; the payload of 20,736
   bytes; the same solve through a one-rank NCCL group formed by
   ``initialize_from_env``, bit for bit the single shard's; the pose graph
   at 512 keyframes with 32 loop edges, 1 and 4 edge shards, the loop
   pulling the chain's end onto the truth. Prints ms an iteration and the
   reduction's share.
12. Diagnostics (``run_diagnostics``): ``System`` on the card with
   visualization on (saving_type "None") and an in-memory sink: every
   alignment level and pose polish emits finite residuals and weights and
   a symmetric JᵀWJ, without PIL or matplotlib.
13. The streaming path (``run_streaming``): ``StreamingTracker`` on the card
   at the bench's geometry and capacities (KITTI intrinsics, 1241×376, four
   levels, 256 features, 150 matches, 512 filters), three chunks of 8
   frames of a plane at 10 m against one reference keyframe: every frame
   within 0.06 m and 0.01 rad of the truth on the card and, through the
   plain versions, on the CPU; the carry is the last frame's outputs; two
   card runs give the same bits; K1 four launches a frame, K2 and K4 one, K3
   none (launches of the capture's warm-up apart); each chunk a replay of
   one CUDA graph, with no host sync in a replay, bit for bit the eager
   loop's, its launches by ``torch.profiler`` as captured. Prints frames/s
   graphed and eager, K2's converged share, the converged filters' depth
   error, the card-CPU gap and the host syncs of a chunk.
14. The port's measurement tools, each from its own functions at the
   shapes it runs at alone: ``tools/bench_multiseq_torch.py`` at its
   defaults (``run_bench_multiseq``: S = 4, textures 0-3, chunks of 8
   supersteps, a warm-up and 2 timed joint chunks, the JAX tool's gate of
   more than 95 % of frames ok); ``tools/profile_system_torch.py``
   (``run_profile_system``: each stage of the frame step a CUDA graph of 20
   chained calls, its own-kernel launches a call as ``PROFILE_OWN`` says);
   ``tools/profile_ablate_torch.py`` (``run_profile_ablate``: a chunk of 8
   supersteps in full and with each stage stubbed out, each its own graph,
   its own-kernel launches a frame as ``ABLATE_OWN`` says, no stub left).
   Prints each one's frames/s or device ms and kernels.
15. Prints the kernels' JSON line (each row with its launches on the main,
   host and streaming paths, in one replay of its path's chunk graph, and
   in ``launches_by_phase``: each path's run, the bench protocol's, the long
   run, the two EuRoC runs and the three tools' phases included, counted
   from 0 just before it), then last the device JSON line.

Imports nothing of JAX. Exits non-zero on any failure, without a result;
alone, without the package beside it, it fails at its first import of
``sdvo_tpu_torch`` (exit code 1).
"""

import collections
import contextlib
import hashlib
import json
import os
import sys
import time

import numpy as np

from bench_torch import N_CHUNKS_TIMED as BENCH_TIMED
from bench_torch import N_GROUPS as BENCH_GROUPS
from bench_torch import SUPERSTEPS_PER_CHUNK as BENCH_SUPERSTEPS
from bench_torch import bench_config, run_protocol

SOURCES = {
    "lm_align_level": ("sdvo_tpu_torch/csrc/lm_align.cu", "sdvo_tpu/ops/pallas_lm.py:410"),
    "fa_align_batch": ("sdvo_tpu_torch/csrc/fa_align.cu", "sdvo_tpu/ops/pallas_fa.py:227"),
    "pose_refine": ("sdvo_tpu_torch/csrc/pose_refine.cu", "sdvo_tpu/ops/pallas_pose.py:244"),
    "depth_scores": ("sdvo_tpu_torch/csrc/depth_scores.cu", "sdvo_tpu/ops/pallas_depth.py:57"),
}
K1_HOST_ROW = "lm_align_level[N512]"  # K1 at the host path's shape: a row of its own
K1_FREEZE_ROW = "lm_align_level[freeze_sigma]"  # K1 with freeze_sigma, which no path sets
BATCH = 8  # sequences of the multi-sequence path, and problems of a batched launch
# texture seeds of the multi-sequence scene: 0-7, each seed that fails the
# main path's gates alone through DeviceSystem replaced by the next that
# passes (tools/check_bench_seeds.py: seeds 1, 2, 3, 5, 9 and 10 track with
# no failed frame but drift 4.5-6.1 % alone)
MULTI_SEEDS = (0, 4, 6, 7, 8, 11, 12, 13)
SUPERSTEPS_PER_CHUNK = 8
N_CHUNKS = 3  # the first is the warm-up; the other two are timed
PER = 3  # keyframe_every_n


def _require(cond: bool, message: str):
    """A gate of this script: raise (an ``assert`` would vanish under -O)."""
    if not cond:
        raise RuntimeError(message)


def check_kernels(device, failures):
    """Each kernel against its plain version at the main path's shapes, with
    its times: the wrapper's on the host clock (``ms``), the kernel's on the
    device (``device_ms``, inputs warm in L2; ``device_ms_cold``, inputs in
    device memory, where the bound is one of bytes above the empty kernel's
    time), the plain version's, and the card's bound."""
    from sdvo_tpu_torch.ops import selfcheck

    empty_ms = selfcheck.device_ms(selfcheck.empty_launch(device))
    print(f"empty kernel: device {empty_ms:.5f} ms a launch (the floor under a one-launch kernel)",
          flush=True)
    print("library_ms: none for any of the four kernels: no single PyTorch call computes a whole "
          "LM solve or a fused sample-centre-ZSSD pass", flush=True)
    rows = {}
    extra = selfcheck.depth_extra_problems(device) + selfcheck.freeze_problems(device)
    for name, args, kw in selfcheck.kernel_problems(device) + extra:
        base = name.split("[")[0]
        kernel, plain = selfcheck.case_calls(name, args, kw)
        got, want = kernel(), plain()
        err, ok = selfcheck.agrees(name, got, want)
        ms = selfcheck.median_ms(kernel)
        plain_ms = selfcheck.median_ms(plain)
        launch, outs = selfcheck.kernel_launcher(name, args, kw)
        dev_ms = selfcheck.device_ms(launch)
        iterations = None
        if base in ("lm_align_level", "pose_refine"):
            iterations = int(outs[1][2])  # what the kernel reports of this problem
        bound = selfcheck.bound_ms(name, selfcheck.problem_shapes(name, args, kw), iterations)
        cold_ms = None
        if bound.by == "bytes" and bound.ms > empty_ms:
            cold_ms = selfcheck.device_ms(selfcheck.cold_launches(name, args, kw, bound.bytes))
        detail = ""
        if base == "fa_align_batch":
            uv_d = (got[0] - want[0]).abs().max(1).values
            flipped = int((uv_d > selfcheck.TOLERANCE[base]).sum())
            detail = (f" ({flipped} of {uv_d.numel()} features one LM step apart, at most "
                      f"{selfcheck.FA_STEP_PX} px and {100 * selfcheck.FA_FLIP_SHARE:g} % allowed)")
        its = "" if iterations is None else f", {iterations} iterations"
        cold = "" if cold_ms is None else f" and {cold_ms:.5f} ms from device memory"
        print(f"kernel {name}: max_abs_err {err:.3e} (tolerance {selfcheck.TOLERANCE[base]:g}"
              f"{detail}){its}, wrapper {ms:.4f} ms, device {dev_ms:.5f} ms warm in L2{cold}, "
              f"plain {plain_ms:.4f} ms, bound {bound.ms:.3e} ms ({bound.by}: {bound.bytes} bytes, "
              f"{bound.flops} operations)",
              flush=True)
        if not ok:
            failures.append(f"{name} disagrees with its plain version: {err}")
        # K1's levels sum to one row a frame (with freeze_sigma, a row of their
        # own); K4's extra shapes are rows of their own
        row = (K1_HOST_ROW if name.startswith(selfcheck.HOST_LM)
               else K1_FREEZE_ROW if name.startswith(selfcheck.FREEZE_LM)
               else name if base == "depth_scores" else base)
        r = rows.setdefault(row, {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                                   "bound_ms": 0.0, "t_bytes": 0.0, "t_flops": 0.0,
                                   "device_ms_cold": cold_ms,
                                   "on_path": name not in {e[0] for e in extra}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        for key, value in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                           ("bound_ms", bound.ms),  # K1: summed over the four levels of one frame
                           ("t_bytes", bound.bytes / selfcheck.PEAK_BYTES_PER_S),
                           ("t_flops", bound.flops / selfcheck.PEAK_F32_FLOPS)):
            r[key] += value
    for r in rows.values():
        r["bound_by"] = "bytes" if r.pop("t_bytes") >= r.pop("t_flops") else "operations"
    check_extra_shapes(device, failures)
    return rows, empty_ms


def check_extra_shapes(device, failures):
    """K1, K2 and K3 against their plain versions at the shapes their thread
    mappings make interesting; nothing is timed."""
    import torch

    from sdvo_tpu_torch.ops import selfcheck

    for name, args, kw in selfcheck.extra_problems(device):
        kernel, plain = selfcheck.case_calls(name, args, kw)
        got = kernel()
        torch.cuda.synchronize()
        err, ok = selfcheck.agrees(name, got, plain())
        exact = name.endswith("-blind]") or name.endswith("[dead]")  # the input comes back
        print(f"extra shape {name}: max_abs_err {err:.3e}" + (" (must be 0)" if exact else ""),
              flush=True)
        if not ok or (exact and err != 0.0):
            failures.append(f"{name} disagrees with its plain version: {err}")


def check_batched_kernels(device, failures, rows, empty_ms: float):
    """Each kernel at ``BATCH`` problems in one launch (the wrapper under
    ``torch.func.vmap``) against its plain version one problem at a time and
    against each problem launched alone (bit for bit), with the times of
    step 3 (the bound summed over the problems, each at the iterations it
    needed); beside the one-problem row's device time."""
    import torch

    from sdvo_tpu_torch.ops import selfcheck

    out = {}
    for name, stacked, kw, problems in selfcheck.batched_problems(device, BATCH):
        base = name.split("[")[0]
        call = selfcheck.batched_call(name, stacked, kw)
        got = call()
        torch.cuda.synchronize()
        plains = [selfcheck.case_calls(name, p, kw)[1] for p in problems]
        err, ok, apart = 0.0, True, 0.0
        for s, (p, plain) in enumerate(zip(problems, plains)):
            mine = selfcheck.pick(got, s)
            e, o = selfcheck.agrees(name, mine, plain())
            err, ok = max(err, e), ok and o
            # and bit for bit what the kernel gives the problem launched alone
            apart = max(apart, selfcheck.max_abs_err(mine, selfcheck.case_calls(name, p, kw)[0]()))
        if apart != 0.0:
            failures.append(f"{name}: a problem of the batch differs from its launch alone by {apart}")
        ms = selfcheck.median_ms(call)
        plain_ms = selfcheck.median_ms(lambda: [p() for p in plains], runs=5)
        launch, outs = selfcheck.kernel_launcher(name, stacked, kw)
        dev_ms = selfcheck.device_ms(launch)
        bounds = []
        for s, p in enumerate(problems):
            its = int(outs[1][s, 2]) if base in ("lm_align_level", "pose_refine") else None
            bounds.append(selfcheck.bound_ms(name, selfcheck.problem_shapes(name, p, kw), its))
        bound = sum(b.ms for b in bounds)
        cold_ms = None
        if bounds[0].by == "bytes" and bound > empty_ms:
            cold_ms = selfcheck.device_ms(selfcheck.cold_launches(name, stacked, kw,
                                                                  sum(b.bytes for b in bounds)))
        print(f"batched kernel {name}: {BATCH} problems in one launch, max_abs_err {err:.3e} "
              f"(tolerance {selfcheck.TOLERANCE[base]:g}, per problem against the plain version; "
              f"{apart:g} against each launched alone), "
              f"wrapper {ms:.4f} ms, device {dev_ms:.5f} ms warm in L2"
              + ("" if cold_ms is None else f" and {cold_ms:.5f} ms from device memory")
              + f", plain {plain_ms:.4f} ms ({BATCH} calls), bound {bound:.3e} ms ({BATCH} problems)",
              flush=True)
        if not ok:
            failures.append(f"{name} disagrees with its plain version: {err}")
        row = f"{base}[S{BATCH}]"
        r = out.setdefault(row, {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                                 "bound_ms": 0.0, "t_bytes": 0.0, "t_flops": 0.0, "device_ms_cold": None,
                                 "on_path": True})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if cold_ms is not None:
            r["device_ms_cold"] = (r["device_ms_cold"] or 0.0) + cold_ms
        for key, value in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                           ("t_bytes", sum(b.bytes for b in bounds) / selfcheck.PEAK_BYTES_PER_S),
                           ("t_flops", sum(b.flops for b in bounds) / selfcheck.PEAK_F32_FLOPS)):
            r[key] += value
    for row, r in out.items():
        r["bound_by"] = "bytes" if r.pop("t_bytes") >= r.pop("t_flops") else "operations"
        one = rows[row.split("[")[0]]["device_ms"]
        print(f"batched kernel {row}: device {r['device_ms']:.5f} ms for {BATCH} problems against "
              f"{one:.5f} ms for one ({r['device_ms'] / one:.2f}x), bound {r['bound_ms']:.3e} ms",
              flush=True)
    rows.update(out)


class LaunchCount:
    """Sets every kernel's launch count to 0 on entry; on exit holds the
    launches of the block and how often a plain version ran on a CUDA tensor
    in it. Under a CUDA graph a launch counts at every replay (captured
    launches × replays, ``pipeline.cuda_graph``), and a capture's warm-up
    launches count too: ``warmup_launches`` says how many of those."""

    def __enter__(self):
        from sdvo_tpu_torch.ops import build

        self.mods = build.kernel_modules()
        for m in self.mods.values():
            m.launches = 0
        self._plain = {k: m.plain_cuda_calls for k, m in self.mods.items()}
        return self

    def __exit__(self, *exc):
        self.launches = {k: m.launches for k, m in self.mods.items()}
        self.plain_on_cuda = {k: m.plain_cuda_calls - self._plain[k] for k, m in self.mods.items()}


# each kernel's function name in csrc/, as torch.profiler names its launches
KERNEL_SYMBOLS = {"lm_align_level": "lm_align_level_kernel", "fa_align_batch": "fa_align_kernel",
                  "pose_refine": "pose_refine_kernel", "depth_scores": "depth_scores_kernel"}


def warmup_launches(graphs) -> dict:
    """Each kernel's launches in the warm-ups of ``graphs`` (``Capture``s of
    ``pipeline.cuda_graph``)."""
    return {k: sum(g.warmup_launches.get(k, 0) for g in graphs) for k in KERNEL_SYMBOLS}


def graph_line(graphs: dict) -> str:
    """Capture seconds, pool bytes, launches a replay and replays of each
    graph of ``graphs`` (name → ``Capture``)."""
    return "; ".join(f"{name}: captured in {g.capture_seconds:.2f} s, pool {g.pool_bytes} B, launches a replay "
                     f"{g.captured_launches}, warm-up launches {g.warmup_launches}, {g.replays} replays"
                     for name, g in graphs.items())


def vo_graphs(vo) -> dict:
    """The ``Capture``s of a ``DeviceVO``'s two graphs, by name ("chunk",
    "superstep"; a second capture of one, in another mode or at other
    shapes, gets its index after the name)."""
    out = {}
    for name, call in (("chunk", vo.chunk_graph), ("superstep", vo.step_graph)):
        for i, g in enumerate(call.graphs.values()):
            out[name if i == 0 else f"{name}{i}"] = g
    return out


def check_replay(name: str, replay, want: dict, graph) -> dict:
    """``replay()`` replays ``graph``, a path's own graph: with every count
    set to 0 just before, one replay must add ``want`` launches, which
    ``torch.profiler``'s kernel events by name must match, and another
    replay must make no host synchronisation. Returns the launches of the
    first replay."""
    before = graph.replays
    with LaunchCount() as counts:
        prof, events, _ = profiled_launches(replay)
    _, syncs = host_syncs(replay)
    print(f"{name}: one replay of its chunk graph launches {counts.launches}, torch.profiler counts {prof} "
          f"({events} device events); host syncs in another replay {len(syncs)}{syncs or ''}", flush=True)
    _require(graph.replays == before + 2, f"the {name}'s calls did not replay its chunk graph")
    _require(counts.launches == want and prof == want,
             f"a replay of the {name}'s chunk graph: {counts.launches} launches counted, {prof} by "
             f"torch.profiler, not {want}")
    _require(not any(counts.plain_on_cuda.values()),
             f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    _require(not syncs, f"host syncs inside a replayed chunk of the {name}: {syncs}")
    return counts.launches


def host_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: (its
    result, each host synchronisation it made, as "file:line: source" of this
    repository's files, in order)."""
    import linecache
    import warnings

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the warnings name the line of the op that synchronized; turning the
    # mode off reports itself from torch's own code
    return out, [f"{os.path.relpath(w.filename, root)}:{w.lineno}: {linecache.getline(w.filename, w.lineno).strip()}"
                 for w in caught if "synchroniz" in str(w.message) and w.filename.startswith(root)]


def profiled_launches(fn):
    """``torch.profiler`` over ``fn()`` on the card: (each kernel's launches,
    by kernel name; the device events in all; the ms in which the device ran
    any of them, overlaps counted once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = collections.Counter(e.name for e in device)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return ({k: sum(n for name, n in names.items() if sym in name) for k, sym in KERNEL_SYMBOLS.items()},
            len(device), busy_us / 1e3)


def chunk_times(fn, frames: int, reps: int = 3):
    """(host ms a frame: the median of ``reps`` calls of ``fn`` on the host
    clock, each ended by a synchronize; device-busy ms a frame in one
    profiled call; the device's idle share, 1 − busy / host)."""
    host = _sync_ms(fn, reps) / frames
    busy = profiled_launches(fn)[2] / frames
    return host, busy, 1.0 - busy / host


def accuracy(trajectory, T_true):
    """(scale-aligned ATE in metres, path length, drift = ATE / path) of the
    tracked poses from frame 2 on."""
    from sdvo_tpu_torch.dataio.evaluate import ate_rmse

    est = np.asarray([-T[:3, :3].T @ T[:3, 3] for T in trajectory[2:]])
    gt = np.asarray([-T[:3, :3].T @ T[:3, 3] for T in T_true[2:len(trajectory)]])
    _require(bool(np.all(np.isfinite(est))), "non-finite poses")
    ate = ate_rmse(est, gt, with_scale=True)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    return ate, path, ate / max(path, 1e-9)


def _track(system, frames, start, stop):
    for i in range(start, stop):
        system.add_image(frames[i].astype(np.float32), float(i))


def tracking_gates(metrics, trajectory, T_true):
    """bench.py's gates on the frames after the bootstrap: none failed, a
    keyframe every ``PER``-th frame, scale-aligned ATE < 0.10 m, drift < 1.5 %.
    Returns (failed frames, keyframes, frames, ATE, path, drift, the broken
    gate or None)."""
    steady = metrics[2:]
    failed = [m["frame"] for m in steady if m["result"] == "FAILED"]
    n_kf = sum(m["result"] == "KEYFRAME" for m in steady)
    broken, ate, path, drift = None, float("inf"), 0.0, float("inf")
    if failed:
        broken = f"tracking failed on frames {failed}"
    elif n_kf != len(steady) // PER:
        broken = f"keyframe cadence broken: {n_kf} of {len(steady)}"
    else:
        ate, path, drift = accuracy(trajectory, T_true)
        if not (ate < 0.10 and drift < 0.015):
            broken = f"accuracy gate failed: ATE {ate}, drift {drift}"
    return failed, n_kf, len(steady), ate, path, drift, broken


def _gate_tracking(name, metrics, trajectory, T_true):
    """``tracking_gates``, failing this script where one is broken."""
    *_, ate, path, drift, broken = tracking_gates(metrics, trajectory, T_true)
    _require(broken is None, f"{name}: {broken}")
    return ate, path, drift


def trajectory_digest(trajectory) -> str:
    """A digest of a trajectory's bits (a failed frame's None as NaNs)."""
    poses = np.asarray([np.full((4, 4), np.nan) if T is None else T for T in trajectory], np.float64)
    return hashlib.sha256(poses.tobytes()).hexdigest()[:16]


def run_main_path(card: str, frames, T_true, name: str = "main path", eager: bool = False):
    """``DeviceSystem`` over the bench scene, in the mode it ships with
    (deterministic algorithms on the card, each chunk a replay of its CUDA
    graph), with its gates, then ``check_replay`` on one more replay of the
    run's own chunk graph; ``eager`` runs its chunks as the Python loop
    (``DeviceVO.run_chunk_eager``) instead, for the A/B. Returns (its
    launches, the frames after the bootstrap, the system, frames/s, each
    kernel's launches in that replay, None when eager)."""
    import torch

    from sdvo_tpu_torch.device import deterministic_on
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    chunk = SUPERSTEPS_PER_CHUNK * PER
    n_frames = 2 + N_CHUNKS * chunk
    ds = DeviceSystem(bench_config(), supersteps_per_chunk=SUPERSTEPS_PER_CHUNK)  # the card by default
    _require(ds.device.type == "cuda", f"DeviceSystem chose {ds.device}, not the card")
    if eager:
        ds.vo.run_chunk = ds.vo.run_chunk_eager

    with LaunchCount() as counts:
        t_start = time.perf_counter()
        _track(ds, frames, 0, 2)
        _require(ds.bootstrapped, "two-view bootstrap failed")
        t_boot = time.perf_counter() - t_start
        chunk_s = []
        for c in range(N_CHUNKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _track(ds, frames, 2 + c * chunk, 2 + (c + 1) * chunk)
            torch.cuda.synchronize()
            chunk_s.append(time.perf_counter() - t0)
        ds.finish()
    launches = counts.launches

    _require(len(ds.trajectory) == n_frames, f"{len(ds.trajectory)} poses for {n_frames} frames")
    ate, path, drift = _gate_tracking(name, ds.metrics, ds.trajectory, T_true)
    print(f"{name}: {n_frames} frames, bootstrap {t_boot:.2f} s, chunk seconds "
          f"{[round(s, 4) for s in chunk_s]}, ATE {ate:.4f} m over {path:.2f} m "
          f"({100 * drift:.3f} % drift; with the first kernels of K1 and K3 it was 0.0016 m, "
          f"0.058 %), launches {launches}, trajectory digest {trajectory_digest(ds.trajectory)}",
          flush=True)
    for k, n in launches.items():
        _require(n > 0, f"kernel {k} never launched on the {name}")
    _require(not any(counts.plain_on_cuda.values()),
             f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    _require(ds.n_relocalizations == 0, f"the {name} fell back to the host")
    graphs = vo_graphs(ds.vo)
    per_replay = None
    if eager:
        _require(not graphs, f"the {name} made a graph")
    else:
        want = {k: (4 if k == "lm_align_level" else 1) * chunk for k in KERNEL_SYMBOLS}
        print(f"{name} graphs: {graph_line(graphs)}", flush=True)
        _require(list(graphs) == ["chunk"] and graphs["chunk"].replays == N_CHUNKS,
                 f"the {name} did not replay its chunk graph once a chunk: {graph_line(graphs)}")
        _require(graphs["chunk"].captured_launches == want, f"a replay of the {name}'s chunk launches "
                 f"{graphs['chunk'].captured_launches}, not {want}")
        # one more replay of this run's own graph, from its last state, on the last chunk's frames
        H, W = frames[0].shape
        imgs = torch.from_numpy(np.stack(frames[n_frames - chunk:n_frames])).to(ds.device).reshape(
            SUPERSTEPS_PER_CHUNK, PER, H, W)
        with deterministic_on(ds.device):
            per_replay = check_replay(name, lambda: ds.vo.run_chunk(ds.state, imgs), want, graphs["chunk"])
    timed = chunk_s[1:]
    fps = len(timed) * chunk / sum(timed)
    print(f"{name} frames/s {fps:.2f} ({card}; DeviceSystem steady state, {len(timed)} chunks of "
          f"{chunk} frames after one warm-up chunk, {'eager' if eager else 'CUDA graphs'})", flush=True)
    return launches, n_frames - 2, ds, fps, per_replay


# bench.py's protocol (bench_torch.py): chunks of 24 supersteps (72 frames a
# dispatch), one warm-up chunk, then 2 groups of 3 timed chunks
BENCH_FRAMES = 2 + (1 + BENCH_GROUPS * BENCH_TIMED) * BENCH_SUPERSTEPS * PER  # 506


def _poses(out):
    """The 4×4 float64 poses of frame outputs with one leading frame axis."""
    T = np.tile(np.eye(4), (len(out.R), 1, 1))
    T[:, :3, :3], T[:, :3, 3] = out.R, out.t
    return list(T)


def run_bench_protocol(card: str, frames, T_true, main_ds):
    """bench.py's protocol through the port on the card:
    ``bench_torch.run_protocol`` on ``DeviceSystem(supersteps_per_chunk=24)``
    on its default device (bootstrap by ``add_image``, the 7 chunks staged on
    the card, ``ds.vo.chunk_fn(24)``: one warm-up chunk, the capture, then 2
    groups of 3 timed chunks, each with a host copy of its outputs) and its
    gates (every frame ok, 168 keyframes, ATE < 0.10 m, drift < 1.5 %). On
    top of them: the first chunk's 72 frames bit for bit the main path's
    (chunks of 8 over the same frames) and ``check_replay`` on one more
    replay (288/72/72/72 launches, no host sync). Returns the run's launches
    (the capture's warm-up included)."""
    import torch

    from sdvo_tpu_torch.device import deterministic_on
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    t_phase = time.perf_counter()
    ds = DeviceSystem(bench_config(), supersteps_per_chunk=BENCH_SUPERSTEPS)  # the card by default
    _require(ds.device.type == "cuda", f"DeviceSystem chose {ds.device}, not the card")
    n = BENCH_SUPERSTEPS * PER
    with LaunchCount() as counts:
        res = run_protocol(ds, frames, T_true, BENCH_SUPERSTEPS, BENCH_GROUPS, BENCH_TIMED)
    out = res["out"]
    graphs = vo_graphs(ds.vo)
    print(f"bench protocol graphs: {graph_line(graphs)}", flush=True)
    print(f"bench protocol ({card}): {res['frames']} frames after the bootstrap in chunks of {BENCH_SUPERSTEPS} "
          f"supersteps, warm-up chunk (the capture) {res['warmup_s']:.3f} s, timed chunk seconds "
          f"{[round(x, 4) for x in res['chunk_s']]}, frames/s a group {[round(x, 2) for x in res['fps_groups']]}, "
          f"median over the timed chunks {float(np.median(res['fps_chunks'])):.2f} (no claim); "
          f"{res['failed_frames']} failed frames, {res['keyframes']} keyframes, ATE {res['ate_m']:.4f} m over "
          f"{res['path_m']:.2f} m ({100 * res['drift']:.3f} % drift); launches {counts.launches}; "
          f"trajectory digest {trajectory_digest(ds.trajectory[:2] + _poses(out))}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    _require(res["broken"] is None, f"bench protocol: {res['broken']}")
    _require(all(k > 0 for k in counts.launches.values()), f"a kernel never launched: {counts.launches}")
    _require(not any(counts.plain_on_cuda.values()), f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    _require(list(graphs) == ["chunk"] and graphs["chunk"].replays == 1 + BENCH_GROUPS * BENCH_TIMED,
             f"the bench protocol did not replay one chunk graph once a chunk: {graph_line(graphs)}")
    # the first chunk's frames bit for bit the main path's (chunks of 8 supersteps)
    main = main_ds.trajectory[2:2 + n]
    same = (all(T is not None for T in main) and bool(out.ok[:n].all())
            and np.array_equal(np.stack(main), np.stack(_poses(out)[:n]))
            and [m["result"] == "KEYFRAME" for m in main_ds.metrics[2:2 + n]] == list(out.is_kf[:n]))
    print(f"bench protocol: the first chunk's {n} frames (R, t, ok, is_kf) "
          f"{'bit for bit' if same else 'DIFFER from'} the main path's (chunks of {SUPERSTEPS_PER_CHUNK})", flush=True)
    _require(same, "the length of a chunk changed the result")
    want = {k: (4 if k == "lm_align_level" else 1) * n for k in KERNEL_SYMBOLS}
    H, W = frames[0].shape
    last = torch.from_numpy(np.stack(frames[BENCH_FRAMES - n:BENCH_FRAMES])).to(ds.device).reshape(
        BENCH_SUPERSTEPS, PER, H, W)
    fn = ds.vo.chunk_fn(BENCH_SUPERSTEPS)
    with deterministic_on(ds.device):  # the mode the graph was captured in
        check_replay("bench protocol", lambda: fn(ds.state, last), want, graphs["chunk"])
    return counts.launches


def _leaves_equal(a, b) -> bool:
    """Whether two trees of tensors hold the same bits, leaf for leaf."""
    import torch

    from sdvo_tpu_torch.pipeline.cuda_graph import flatten

    la, lb = flatten(a)[0], flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.contiguous().view(-1).view(torch.uint8), y.contiguous().view(-1).view(torch.uint8)) for x, y in zip(la, lb))


def run_graph_checks(card: str, frames):
    """``DeviceVO.run_chunk``'s graphs against the eager loop, from one
    bootstrapped state of the bench scene: a chunk of 8 supersteps (its
    capture) and the next, each bit for bit the eager chunk's; the first
    chunk's outputs untouched by the second replay (no aliasing); no host
    a tail of one superstep through the superstep graph, bit for bit. Also
    lists the host synchronisations of one eager superstep (none: the
    superstep is capture-safe) and times a chunk graphed and eager. The
    main path's own graph is held to its launches and host syncs by
    ``check_replay`` in ``run_main_path``."""
    import torch

    from sdvo_tpu_torch.device import deterministic_on
    from sdvo_tpu_torch.pipeline.cuda_graph import flatten
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    ds = DeviceSystem(bench_config(), supersteps_per_chunk=SUPERSTEPS_PER_CHUNK)
    _track(ds, frames, 0, 2)
    _require(ds.bootstrapped, "two-view bootstrap failed")
    n = SUPERSTEPS_PER_CHUNK * PER
    H, W = frames[0].shape
    imgs = [torch.from_numpy(np.stack(frames[2 + c * n:2 + (c + 1) * n])).to(ds.device).reshape(
        SUPERSTEPS_PER_CHUNK, PER, H, W) for c in range(2)]
    vo, state0 = ds.vo, ds.state
    with deterministic_on(ds.device):
        vo.superstep(state0, imgs[0][0])
        _, eager_syncs = host_syncs(lambda: vo.superstep(state0, imgs[0][0]))
        e1 = vo.run_chunk_eager(state0, imgs[0])
        g1 = vo.run_chunk(state0, imgs[0])
        kept = [x.clone() for x in flatten(g1)[0]]
        g2 = vo.run_chunk(g1[0], imgs[1])
        e2 = vo.run_chunk_eager(e1[0], imgs[1])
        untouched = all(torch.equal(a, b) for a, b in zip(kept, flatten(g1)[0]))
        t_graph = vo.run_chunk(g2[0], imgs[0][:1])
        t_eager = vo.run_chunk_eager(e2[0], imgs[0][:1])
        timed = {way: chunk_times(lambda: run(g1[0], imgs[1]), n)
                 for way, run in (("eager", vo.run_chunk_eager), ("graph", vo.run_chunk))}
    same = [_leaves_equal(e1, g1), _leaves_equal(e2, g2), _leaves_equal(t_eager, t_graph)]
    print(f"graphs ({card}): chunk 1, chunk 2 and a one-superstep tail graphed against eager: "
          f"{['the same bits' if s else 'DIFFERENT bits' for s in same]}; chunk 1's outputs "
          f"{'untouched' if untouched else 'CHANGED'} by the next replay; host syncs in one eager superstep "
          f"{len(eager_syncs)}{eager_syncs or ''}; {graph_line(vo_graphs(vo))}", flush=True)
    print(f"main path chunk of {n} frames ({card}), host ms a frame / device-busy ms a frame / idle share: "
          + "; ".join(f"{way} {h:.3f} / {b:.3f} / {i:.3f}" for way, (h, b, i) in timed.items()), flush=True)
    _require(all(same), "a graphed chunk differs from the eager loop")
    _require(untouched, "a replay overwrote the outputs of the chunk before it")


HOST_FRAMES = 2 + 24  # the host path's run
CHECKPOINT_FRAMES = 3  # tracked by a fresh System after the checkpoint


def run_host_path(card: str, frames, T_true):
    """The per-frame host ``System`` on the card, then the checkpoint: a
    fresh ``System`` loads what the first saved and tracks on."""
    import shutil
    import tempfile

    import torch

    from sdvo_tpu_torch.pipeline.system import FrameResult, System

    system = System(bench_config())  # the card by default
    _require(system.device.type == "cuda", f"System chose {system.device}, not the card")
    with LaunchCount() as counts:
        _track(system, frames, 0, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _track(system, frames, 2, HOST_FRAMES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = counts.launches
    n_steady = HOST_FRAMES - 2
    ate, path, drift = _gate_tracking("host path", system.metrics, system.trajectory, T_true)
    print(f"host path: {HOST_FRAMES} frames frame by frame, ATE {ate:.4f} m over {path:.2f} m "
          f"({100 * drift:.3f} % drift), windowed BA solved on {system.n_local_ba} keyframes, "
          f"launches {launches}", flush=True)
    print(f"host path frames/s {n_steady / seconds:.2f} ({card}; System, {n_steady} frames after the "
          f"bootstrap, the first of them warming up)\n{system.timers.report()}", flush=True)
    _require(launches["lm_align_level"] == 4 * n_steady,
             f"K1 launched {launches['lm_align_level']} times on {n_steady} frames, not four a frame")
    _require(0 < launches["fa_align_batch"] <= n_steady and 0 < launches["depth_scores"] <= n_steady,
             f"K2 and K4 launch once a frame on the host path: {launches}")
    _require(launches["pose_refine"] == 0, "K3 launched on the host path, which polishes with optimize_pose")
    _require(not any(counts.plain_on_cuda.values()),
             f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    _require(system.n_local_ba >= 1, "the windowed BA never solved on the host path")

    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "checkpoint.npz")
        system.save_checkpoint(path)
        fresh = System(bench_config())
        fresh.load_checkpoint(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _require(fresh.frame_count == HOST_FRAMES and len(fresh.trajectory) == HOST_FRAMES,
             "the checkpoint lost frames")
    results = [fresh.add_image(frames[i].astype(np.float32), float(i))
               for i in range(HOST_FRAMES, HOST_FRAMES + CHECKPOINT_FRAMES)]
    _require(FrameResult.FAILED not in results, f"after the checkpoint: {[r.name for r in results]}")
    ate, path, drift = accuracy(fresh.trajectory, T_true)
    _require(ate < 0.10 and drift < 0.015, f"after the checkpoint: ATE {ate}, drift {drift}")
    print(f"checkpoint: saved after {HOST_FRAMES} frames, loaded into a fresh System, "
          f"{[r.name for r in results]}, ATE {ate:.4f} m", flush=True)
    return launches, n_steady


REC_SUPERSTEPS = 2  # a chunk of the recovery run: 6 frames
REC_BLACK = range(11, 14)  # the second superstep of the second chunk
REC_FRAMES = 14 + 8 + 2 * REC_SUPERSTEPS * PER  # blackout, room for the host path, two chunks


def _drive_recovery(seq, device):
    """``DeviceSystem`` over the blackout sequence. Returns it, what it looked
    like right after the failed chunk, the frame on which ``_pack`` put the
    state back on the device, and the replays of its chunk graph (on the
    card) after the failed chunk and at the re-pack."""
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    ds = DeviceSystem(bench_config(), supersteps_per_chunk=REC_SUPERSTEPS, device=device)
    after_failure, repacked, replays = None, None, [None, None]

    def chunk_replays():
        return sum(g.replays for g in ds.vo.chunk_graph.graphs.values())

    for i, im in enumerate(seq):
        on_host = ds.state is None
        ds.add_image(im.astype(np.float32), float(i))
        if i == REC_BLACK[-1]:
            after_failure = (ds.n_relocalizations, ds.state is None, ds.host.status.name)
            replays[0] = chunk_replays()
        if i > REC_BLACK[-1] and on_host and ds.state is not None and repacked is None:
            repacked = i
            replays[1] = chunk_replays()
    ds.finish()
    return ds, after_failure, repacked, replays


def run_recovery(card: str, frames):
    """Failure and recovery: the card against the CPU, frame for frame."""
    seq = [np.zeros_like(f) if i in REC_BLACK else f for i, f in enumerate(frames[:REC_FRAMES])]
    t0 = time.perf_counter()
    with LaunchCount() as counts:
        ds, after_failure, repacked, replays = _drive_recovery(seq, None)  # the card by default
    t_card = time.perf_counter() - t0
    _require(ds.device.type == "cuda", f"DeviceSystem chose {ds.device}, not the card")
    results = [m["result"] for m in ds.metrics]
    via = ["device" if "align_rmse" in m else "host" for m in ds.metrics]
    print(f"recovery: {len(seq)} frames, black {list(REC_BLACK)}, {ds.n_relocalizations} "
          f"relocalization(s), back on the device after frame {repacked}; results "
          f"{''.join(r[0] for r in results)}, via {''.join(v[0] for v in via)} ({card}, {t_card:.1f} s)",
          flush=True)
    _require(len(results) == len(seq), f"{len(results)} results for {len(seq)} frames")
    black = list(REC_BLACK)
    _require(all(results[i] == "FAILED" and ds.trajectory[i] is None for i in black),
             f"the black frames did not fail: {results[black[0]:black[-1] + 1]}")
    _require("FAILED" not in results[:black[0]], "a frame failed before the blackout")
    _require(after_failure == (1, True, "RELOCALIZATION"),
             f"after the failed chunk (relocalizations, state is None, host status): {after_failure}")
    _require(repacked is not None, "the state never went back to the device")
    _require(results[repacked] == "KEYFRAME" and via[repacked] == "host",
             "the state must go back on a keyframe of the host path")
    _require(set(via[black[-1] + 1:repacked + 1]) == {"host"}, "the host path did not take over")
    tail = range(repacked + 1, len(seq))
    _require(len(tail) >= 2 * REC_SUPERSTEPS * PER and all(via[i] == "device" for i in tail),
             f"fewer than two chunks on the device after the recovery: {via[repacked + 1:]}")
    _require(all(results[i] != "FAILED" for i in tail) and ds.state is not None,
             f"tracking failed again after the recovery: {results[repacked + 1:]}")
    _require(all(n > 0 for n in counts.launches.values()), f"a kernel never launched: {counts.launches}")
    _require(not any(counts.plain_on_cuda.values()),
             f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    graphs = vo_graphs(ds.vo)
    graph = graphs.get("chunk")
    print(f"recovery graphs: {graph_line(graphs)}; the chunk graph replayed {replays[0]} times before the "
          f"blackout's relocalization, {replays[1]} at the re-pack, {graph.replays if graph else 0} at the end",
          flush=True)
    _require(graph is not None and len(ds.vo.chunk_graph.graphs) == 1 and len(ds.vo.step_graph.graphs) <= 1
             and replays[0] >= 2 and graph.replays > replays[1] == replays[0],
             "the re-packed state did not go back into the chunk graph captured before the blackout")
    t0 = time.perf_counter()
    twin, _, twin_repacked, _ = _drive_recovery(seq, "cpu")
    twin_results = [m["result"] for m in twin.metrics]
    print(f"recovery on the CPU (plain versions): back on the device path after frame "
          f"{twin_repacked}, results {''.join(r[0] for r in twin_results)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    _require(twin_results == results and twin_repacked == repacked,
             "the port on the card and the port on the CPU disagree on a frame's result")


# the JAX package's long run (tests/test_long_sequence.py): its overrides
# (:69-81) and DeviceSystem arguments (:82-83), 300 frames, black 150-158
LONG_OVERRIDES = {
    "camera": {"img_width": 320, "img_height": 240},
    "initialization": {"min_detected_points": 60, "desired_detected_points": 150,
                       "threshold_gradient_magnitude": 20, "disparity_threshold": 2},
    "algorithm": {"cell_pixel_size": 24, "min_tracked_features": 20, "max_dropped_features": 150,
                  "max_reprojection_matches": 96, "max_features_per_frame": 160, "max_points": 1024,
                  "max_filters": 256, "keyframe_every_n": 3},
}
LONG_KW = dict(supersteps_per_chunk=4, max_promote=32, ba_points=256, ba_iterations=4)
LONG_FRAMES = 300
LONG_BLACK = range(150, 159)


def long_config():
    from sdvo_tpu_torch.config import load_config

    return load_config(overrides=LONG_OVERRIDES)


def drift(est, gt):
    """(scale-aligned ATE, path length of ``gt``) of camera centres."""
    from sdvo_tpu_torch.dataio.evaluate import ate_rmse

    return ate_rmse(est, gt, with_scale=True), float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))


def _centres_of(trajectory, T_true):
    """(estimated centres, true centres, frame indices) of the tracked frames."""
    idx = [i for i, T in enumerate(trajectory) if T is not None]
    c = lambda T: -T[:3, :3].T @ T[:3, 3]  # noqa: E731
    return (np.asarray([c(trajectory[i]) for i in idx]), np.asarray([c(T_true[i]) for i in idx]),
            np.asarray(idx))


def long_gates(ds, T_true) -> dict:
    """Every gate of ``tests/test_long_sequence.py`` at its thresholds;
    returns the numbers they read."""
    cfg = ds.config.algorithm
    black = LONG_BLACK
    _require(len(ds.trajectory) == LONG_FRAMES, f"{len(ds.trajectory)} poses for {LONG_FRAMES} frames")
    est, gt, idx = _centres_of(ds.trajectory, T_true)
    pre = idx < black.start
    _require(pre.sum() >= black.start - 3, f"only {pre.sum()} frames tracked before the blackout")
    ate_pre, path_pre = drift(est[pre], gt[pre])
    _require(ate_pre / path_pre < 0.06, f"drift before the blackout {ate_pre / path_pre}")
    results = [m["result"] for m in ds.metrics]
    _require("FAILED" in results[black.start:black.stop + 3], "no frame failed in the blackout")
    _require(ds.n_relocalizations >= 1, "no relocalization")
    post = results[black.stop + 5:]
    frac_ok = float(np.mean([r != "FAILED" for r in post]))
    _require(frac_ok > 0.9, f"only {frac_ok:.0%} of the frames after the blackout tracked")
    _require(ds.bootstrapped, "the device path did not re-engage")
    if ds.state is not None:
        n_live, n_ever = int(ds.state.map.kf_valid.sum()), int(ds.state.map.kf_counter)
    else:
        n_live, n_ever = ds.host.arena.num_keyframes(), ds.host.arena.kf_counter
    _require(n_live <= cfg.max_keyframes + 1 and n_ever >= 60 and n_ever - n_live >= 40,
             f"keyframes: {n_ever} made, {n_live} live")
    caps = [m["n_filters"] for m in ds.metrics if "n_filters" in m]
    _require(max(caps) <= cfg.max_filters and caps[-1] > 0, f"filter bank: peak {max(caps)}, last {caps[-1]}")
    ate, path = drift(est, gt)
    _require(ate / path < 0.12, f"drift over the run {ate / path}")
    _require((idx >= black.stop).sum() > 100, "fewer than 100 frames tracked after the blackout")
    return {"drift_pre": ate_pre / path_pre, "drift": ate / path, "keyframes": n_ever, "evicted": n_ever - n_live,
            "peak_filters": max(caps), "relocalizations": ds.n_relocalizations, "post_ok": frac_ok,
            "failed": [i for i, r in enumerate(results) if r == "FAILED"]}


def drive_long(frames, device=None):
    """``DeviceSystem`` with the long run's configuration over ``frames``.
    Returns it, the frames/s of the whole run (host frames included) and
    the replays of its first chunk graph (the 4-superstep chunk, captured
    before the blackout) at the relocalization, at the re-pack and at the
    end."""
    import torch

    from sdvo_tpu_torch.dataio.synthetic import LONG_CAMERA
    from sdvo_tpu_torch.geometry.camera import PinholeCamera
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    ds = DeviceSystem(long_config(), camera=PinholeCamera.create(**LONG_CAMERA), device=device, **LONG_KW)
    at = {}

    def first_replays():
        graphs = list(ds.vo.chunk_graph.graphs.values())
        return graphs[0].replays if graphs else 0

    t0 = time.perf_counter()
    for i, im in enumerate(frames):
        on_host, relocs = ds.state is None, ds.n_relocalizations
        ds.add_image(im, float(i))
        if ds.n_relocalizations > relocs and "reloc" not in at:
            at["reloc"] = (i, first_replays(), len(ds.vo.chunk_graph.graphs))
        if "reloc" in at and on_host and ds.state is not None and "repack" not in at:
            at["repack"] = (i, first_replays())
    ds.finish()
    if ds.device.type == "cuda":
        torch.cuda.synchronize()
    return ds, len(frames) / (time.perf_counter() - t0), at, first_replays()


def run_long(card: str):
    """The JAX package's long run on the card (``DeviceSystem`` as it ships:
    deterministic algorithms, each chunk a replay of its CUDA graph): 300
    frames with a blackout at 150-158, every gate of
    ``tests/test_long_sequence.py``, two runs with one digest, and the
    relocalization re-packed into the chunk graph captured before the
    blackout. Returns the first run's launches."""
    from sdvo_tpu_torch.dataio.synthetic import render_long_sequence

    t_phase = time.perf_counter()
    frames, T_true = render_long_sequence(LONG_FRAMES, LONG_BLACK)
    t_render = time.perf_counter() - t_phase
    with LaunchCount() as counts:
        ds, fps, at, replays_end = drive_long(frames)
    _require(ds.device.type == "cuda", f"DeviceSystem chose {ds.device}, not the card")
    gates = long_gates(ds, T_true)
    _require(all(n > 0 for n in counts.launches.values()), f"a kernel never launched: {counts.launches}")
    _require(not any(counts.plain_on_cuda.values()), f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    graphs = vo_graphs(ds.vo)
    print(f"long run graphs: {graph_line(graphs)}; the first chunk graph replayed {at.get('reloc')} "
          f"(frame, replays, graphs) at the relocalization, {at.get('repack')} (frame, replays) at the "
          f"re-pack, {replays_end} at the end", flush=True)
    _require("reloc" in at and "repack" in at and at["reloc"][1] >= 2
             and replays_end > at["repack"][1] == at["reloc"][1],
             "the re-packed state did not go back into the chunk graph captured before the blackout")
    again, fps_again, _, _ = drive_long(frames)
    digests = [trajectory_digest(d.trajectory) for d in (ds, again)]
    _require(digests[0] == digests[1], f"the long run's two graphed runs differ: {digests}")
    print(f"long run: {LONG_FRAMES} frames (320x240, black {LONG_BLACK.start}-{LONG_BLACK.stop - 1}), "
          f"{gates['keyframes']} keyframes made, {gates['evicted']} evicted, peak {gates['peak_filters']} filters, "
          f"{gates['relocalizations']} relocalization(s), failed frames {gates['failed']}, "
          f"{100 * gates['post_ok']:.1f} % tracked after the blackout, drift {100 * gates['drift_pre']:.3f} % before "
          f"the blackout and {100 * gates['drift']:.3f} % over the run; frames/s {fps:.2f} and {fps_again:.2f} "
          f"(the whole run, host frames included); digest {digests[0]} twice; launches {counts.launches}; "
          f"{time.perf_counter() - t_phase:.1f} s ({t_render:.1f} s rendering; {card})", flush=True)
    return counts.launches


# BASELINE config 2, EuRoC MH_01 at 5 levels: tests/test_euroc.py's overrides
# and camera; its System over 10 frames of the dolly (seed 11), and
# DeviceSystem over 2 + 24 frames of the same dolly (the JAX DeviceSystem
# tracks them on the CPU with no failed frame)
EUROC_OVERRIDES = {
    "camera": {"img_width": 752, "img_height": 480},
    "initialization": {"min_detected_points": 60, "desired_detected_points": 150,
                       "threshold_gradient_magnitude": 20, "disparity_threshold": 2},
    "algorithm": {"max_level_image_pyramid": 4, "min_tracked_features": 20, "max_features_per_frame": 160,
                  "max_reprojection_matches": 96, "max_points": 1024, "max_filters": 256},
}
EUROC_SYSTEM_FRAMES = 10
EUROC_DEVICE_FRAMES = 2 + 24
EUROC_SEED = 11
EUROC_LEVELS = 5
EUROC_SCHEDULE = [4, 4, 6, 8, 10]  # K1's iterations at levels 0-4 on the device path


def euroc_config():
    from sdvo_tpu_torch.config import load_config

    return load_config(overrides=EUROC_OVERRIDES)


def euroc_system_gates(system):
    """``tests/test_euroc.py``'s gates: at least 8 frames SUCCESS or
    KEYFRAME, more map points at the end than after the bootstrap."""
    ok = [m for m in system.metrics if m.get("result") in ("SUCCESS", "KEYFRAME")]
    _require(len(ok) >= 8, f"EuRoC System: {len(ok)} frames tracked")
    first, last = system.metrics[1].get("n_points", 0), system.metrics[-1].get("n_points", 0)
    _require(last > first, f"EuRoC System: {last} points at the end, {first} after the bootstrap")
    return len(ok), first, last


def drive_euroc_device(frames, device=None):
    """``DeviceSystem`` at the EuRoC preset over ``frames`` (chunks of 8
    supersteps). Returns it and its frames/s after the bootstrap."""
    import torch

    from sdvo_tpu_torch.dataio.synthetic import EUROC_CAMERA
    from sdvo_tpu_torch.geometry.camera import PinholeCamera
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    ds = DeviceSystem(euroc_config(), camera=PinholeCamera.create(**EUROC_CAMERA), device=device,
                      supersteps_per_chunk=SUPERSTEPS_PER_CHUNK)
    _track(ds, frames, 0, 2)
    t0 = time.perf_counter()
    _track(ds, frames, 2, len(frames))
    ds.finish()
    if ds.device.type == "cuda":
        torch.cuda.synchronize()
    return ds, (len(frames) - 2) / (time.perf_counter() - t0)


def run_euroc(card: str):
    """BASELINE config 2 on the card: ``System`` as ``tests/test_euroc.py``
    runs it (752x480, 5 levels, 10 frames) with that test's gates and K1
    five launches a frame; then ``DeviceSystem`` at the same preset over
    2 + 24 frames: no failed frame, exact keyframe cadence, K1 five launches
    a frame at 4/4/6/8/10 iterations (levels 0-4), the chunk graph captured
    at 5 levels, two graphed runs with one digest. Returns the launches of
    the ``System`` run and of the first ``DeviceSystem`` run."""
    import torch

    from sdvo_tpu_torch.dataio.synthetic import EUROC_CAMERA, render_dolly_sequence
    from sdvo_tpu_torch.geometry.camera import PinholeCamera
    from sdvo_tpu_torch.pipeline.system import System

    t_phase = time.perf_counter()
    frames, T_true = render_dolly_sequence(EUROC_CAMERA, EUROC_DEVICE_FRAMES, EUROC_SEED)
    system = System(euroc_config(), camera=PinholeCamera.create(**EUROC_CAMERA))  # the card by default
    _require(system.device.type == "cuda", f"System chose {system.device}, not the card")
    _require(system.num_levels == EUROC_LEVELS, f"System builds {system.num_levels} levels")
    with LaunchCount() as sys_counts:
        _track(system, frames, 0, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _track(system, frames, 2, EUROC_SYSTEM_FRAMES)
        torch.cuda.synchronize()
        sys_s = time.perf_counter() - t0
    n_ok, first, last = euroc_system_gates(system)
    n_tracked = EUROC_SYSTEM_FRAMES - 2
    _require(sys_counts.launches["lm_align_level"] == EUROC_LEVELS * n_tracked,
             f"K1 launched {sys_counts.launches['lm_align_level']} times on {n_tracked} frames, not five a frame")
    _require(not any(sys_counts.plain_on_cuda.values()),
             f"plain versions ran on CUDA tensors: {sys_counts.plain_on_cuda}")
    print(f"EuRoC System: {EUROC_SYSTEM_FRAMES} frames at 752x480, {EUROC_LEVELS} levels, {n_ok} tracked, points "
          f"{first} after the bootstrap and {last} at the end, results "
          f"{''.join(m['result'][0] for m in system.metrics)}, launches {sys_counts.launches}, frames/s "
          f"{n_tracked / sys_s:.2f} ({card})", flush=True)

    with LaunchCount() as counts:
        ds, fps = drive_euroc_device(frames)
    _require(ds.device.type == "cuda", f"DeviceSystem chose {ds.device}, not the card")
    steady = ds.metrics[2:]
    failed = [m["frame"] for m in steady if m["result"] == "FAILED"]
    n_kf = sum(m["result"] == "KEYFRAME" for m in steady)
    _require(not failed and ds.n_relocalizations == 0, f"EuRoC DeviceSystem: failed frames {failed}")
    _require([m["result"] == "KEYFRAME" for m in steady] == [(i + 1) % PER == 0 for i in range(len(steady))],
             f"EuRoC DeviceSystem: keyframe cadence broken ({n_kf} of {len(steady)})")
    schedule = [ds.vo.aligner.level_iterations(lv) for lv in range(EUROC_LEVELS)]
    _require(ds.scfg.levels == EUROC_LEVELS and schedule == EUROC_SCHEDULE,
             f"EuRoC DeviceSystem: {ds.scfg.levels} levels at {schedule} iterations")
    n_steady = len(steady)
    graphs = vo_graphs(ds.vo)
    warm = warmup_launches(graphs.values())  # the capture's warm-up runs the chunk once more
    _require(counts.launches["lm_align_level"] - warm["lm_align_level"] == EUROC_LEVELS * n_steady,
             f"K1 launched {counts.launches['lm_align_level']} times ({warm['lm_align_level']} in the capture's "
             f"warm-up) on {n_steady} frames, not five a frame")
    _require(not any(counts.plain_on_cuda.values()), f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    chunk = SUPERSTEPS_PER_CHUNK * PER
    want = {k: (EUROC_LEVELS if k == "lm_align_level" else 1) * chunk for k in KERNEL_SYMBOLS}
    _require("chunk" in graphs and graphs["chunk"].captured_launches == want,
             f"the EuRoC chunk graph: {graph_line(graphs)}, not {want} a replay")
    again, fps_again = drive_euroc_device(frames)
    digests = [trajectory_digest(d.trajectory) for d in (ds, again)]
    _require(digests[0] == digests[1], f"the EuRoC DeviceSystem's two graphed runs differ: {digests}")
    ate, path = drift(*_centres_of(ds.trajectory, T_true)[:2])
    print(f"EuRoC DeviceSystem: {EUROC_DEVICE_FRAMES} frames, no failed frame, {n_kf} keyframes of {n_steady}, "
          f"K1 at {schedule} iterations (levels 0-4), graphs {graph_line(graphs)}, launches {counts.launches}, "
          f"scale-aligned ATE {ate:.4f} over a path of {path:.3f} ({100 * ate / path:.2f} %), frames/s {fps:.2f} "
          f"and {fps_again:.2f} (one chunk of 24 frames and its capture), digest {digests[0]} twice; "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return sys_counts.launches, counts.launches


FOUR_OPS = ("sdvo::lm_align_level", "sdvo::fa_align_batch", "sdvo::pose_refine", "sdvo::depth_scores")


def _multi_fps(ms):
    """(aggregate, per-sequence) frames/s of the joint chunks after the first."""
    timed = ms.chunk_seconds[1:]
    _require(len(timed) >= 2, f"{len(ms.chunk_seconds)} joint chunks, fewer than three")
    agg = len(timed) * SUPERSTEPS_PER_CHUNK * PER * ms.n_seq / sum(timed)
    return agg, agg / ms.n_seq


def run_multi_seq(card: str, seqs, T_true, main_ds, main_fps: float, main_fps_again: float):
    """``MultiSequenceSystem`` over ``BATCH`` sequences on the card (its joint
    chunks replays of their CUDA graph), then over the same sequences with
    the joint chunks as the eager loop (``chunk_fn.eager``), which must give
    the same bits, then over sequence 0 alone. Returns the joint phase's
    launches, its frame steps and the joint graph's launches a replay."""
    from sdvo_tpu_torch.parallel import MultiSequenceSystem, vmap_fallbacks

    ms = MultiSequenceSystem(bench_config(), len(seqs), supersteps_per_chunk=SUPERSTEPS_PER_CHUNK)
    _require(all(sub.device.type == "cuda" for sub in ms.subs), "MultiSequenceSystem is not on the card")
    t0 = time.perf_counter()
    ms.bootstrap(seqs)
    t_boot = time.perf_counter() - t0
    with LaunchCount() as counts, vmap_fallbacks() as fallbacks:
        ms.joint(seqs)
    timed = _joint_times(ms, seqs)
    results = ms.tail(seqs)
    steps = ms.frame_steps
    launches = counts.launches
    for i, (seed, res) in enumerate(zip(MULTI_SEEDS, results)):
        _require(len(res["trajectory"]) == len(seqs[i]), f"sequence {i}: {len(res['trajectory'])} poses")
        ate, path, drift = _gate_tracking(f"sequence {i} (seed {seed})", res["metrics"], res["trajectory"], T_true)
        print(f"multi-sequence {i} (seed {seed}): ATE {ate:.4f} m over {path:.2f} m "
              f"({100 * drift:.3f} % drift)", flush=True)
    main_res = [m["result"] for m in main_ds.metrics]
    _require([m["result"] for m in results[0]["metrics"]] == main_res,
             "sequence 0 of the multi-sequence run and the main path disagree on a frame's result")
    c_multi, c_main = _centres(results[0]["trajectory"]), _centres(main_ds.trajectory)
    path = float(np.sum(np.linalg.norm(np.diff(c_main, axis=0), axis=-1)))
    apart = float(np.linalg.norm(c_multi - c_main, axis=-1).max())
    print(f"multi-sequence 0 against the main path: the same {len(main_res)} results, camera centres "
          f"at most {apart:.3e} m apart ({100 * apart / path:.4f} % of the {path:.2f} m path)", flush=True)
    _require(apart < 0.02 * path, f"sequence 0 drifts from the main path: {apart} m of {path} m")
    graphs = ms.chunk_fn.graph.graphs
    warm = warmup_launches(graphs.values())
    print(f"multi-sequence launches over {steps} frame steps of {len(seqs)} sequences: {launches}, of them "
          f"{warm} in the capture's warm-up; vmap fallbacks {sorted(fallbacks) or 'none'}; joint graph: "
          f"{graph_line({'joint': g for g in graphs.values()})}", flush=True)
    _require(len(graphs) == 1, f"{len(graphs)} joint graphs for one group and one chunk length")
    captured = next(iter(graphs.values())).captured_launches
    for k, n in launches.items():
        want = 4 * steps if k == "lm_align_level" else steps
        _require(n - warm[k] == want, f"{k} launched {n - warm[k]} times over {steps} frame steps, not {want}")
    _require(not any(counts.plain_on_cuda.values()),
             f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    _require(not fallbacks & set(FOUR_OPS), f"vmap looped over the batch for {fallbacks & set(FOUR_OPS)}")
    agg, per_seq = _multi_fps(ms)

    eager = MultiSequenceSystem(bench_config(), len(seqs), supersteps_per_chunk=SUPERSTEPS_PER_CHUNK)
    eager.chunk_fn = eager.chunk_fn.eager
    eager_res = eager.run(seqs)
    same = all(np.array_equal(np.asarray(a["trajectory"]), np.asarray(b["trajectory"]))
               for a, b in zip(results, eager_res))
    agg_eager, _ = _multi_fps(eager)
    print(f"multi-sequence, joint chunks as the eager loop: {'the same' if same else 'DIFFERENT'} trajectory "
          f"bits as through the graph; {agg_eager:.2f} aggregate frames/s against the graph's {agg:.2f} ({card}); "
          f"a joint chunk at S = {len(seqs)}, host ms a frame step / device-busy ms a frame step / idle share: "
          + "; ".join(f"{way} {h:.3f} / {b:.3f} / {i:.3f}" for way, (h, b, i) in timed.items()), flush=True)
    _require(same, "the graphed joint chunks and the eager loop gave different trajectories")

    one = MultiSequenceSystem(bench_config(), 1, supersteps_per_chunk=SUPERSTEPS_PER_CHUNK)
    one_res = one.run(seqs[:1])
    _require([m["result"] for m in one_res[0]["metrics"]] == main_res,
             "MultiSequenceSystem at S = 1 and the main path disagree on a frame's result")
    agg1, _ = _multi_fps(one)
    print(f"multi-sequence frames/s ({card}; joint chunks of {SUPERSTEPS_PER_CHUNK * PER} frame steps, "
          f"two timed after one warm-up): S = {len(seqs)}: {agg:.2f} aggregate, {per_seq:.2f} a sequence; "
          f"S = 1: {agg1:.2f}; the main path (DeviceSystem): {main_fps:.2f} and {main_fps_again:.2f} in "
          f"its two runs; bootstrap of {len(seqs)} sequences {t_boot:.2f} s", flush=True)
    return launches, steps, captured, warm, {len(seqs): agg, 1: agg1}


def _joint_times(ms, seqs):
    """``chunk_times`` of one joint chunk from the state after the joint
    phase (the first chunk's frames again), through the graph and as the
    eager loop."""
    import torch

    from sdvo_tpu_torch.device import deterministic_on

    n = SUPERSTEPS_PER_CHUNK * PER
    imgs = np.stack([np.stack(s[2:2 + n]) for s in seqs]).reshape(len(seqs), SUPERSTEPS_PER_CHUNK, PER,
                                                                    *seqs[0][0].shape)
    imgs = torch.from_numpy(np.ascontiguousarray(imgs.transpose(1, 0, 2, 3, 4))).to(ms.groups[0][0])
    state = ms._state
    with deterministic_on(imgs.device):
        return {way: chunk_times(lambda: fn(state, imgs), n)
                for way, fn in (("eager", ms.chunk_fn.eager), ("graph", ms.chunk_fn))}


ISO_SUPERSTEPS = 2  # chunks of the isolation runs: 6 frames
ISO_FRAMES = 2 + 2 * ISO_SUPERSTEPS * PER  # bootstrap and two joint chunks, no tail


def _centres(trajectory):
    return np.asarray([-T[:3, :3].T @ T[:3, 3] for T in trajectory])


def _bits(tree):
    """The tensor leaves of a state or output tree as numpy arrays."""
    from sdvo_tpu_torch.parallel.mesh import tree_map

    leaves = []
    tree_map(lambda x: leaves.append(x.cpu().numpy()), tree)
    return leaves


def joint_by_slot(pair, supersteps: int, n_chunks: int, orders=((0, 1), (1, 0)), around=None, device=None):
    """The two sequences of ``pair`` bootstrapped once by
    ``MultiSequenceSystem`` (two host frames each), then ``n_chunks`` joint
    chunks of ``supersteps`` supersteps of the vmapped superstep
    (``multi_chunk_fn``, in the mode the joint phase runs in) on their states
    stacked in each order of ``orders``, on ``device`` (the card by default).
    Without ``around`` the chunks replay their CUDA graph, as the joint phase
    does; with it the k-th order runs inside ``around(k)`` as the eager loop
    (``fn.eager``), so that a dispatch mode there sees every op (a replay
    dispatches none, and a capture cannot hold a mode that reads tensors on
    the host).
    Returns for each order, by sequence (not slot), the numpy arrays of that
    sequence's frame outputs and final state: a sequence in another slot
    starts from the same bits, so only the superstep can make them differ."""
    import torch

    from sdvo_tpu_torch.device import deterministic_on
    from sdvo_tpu_torch.parallel import MultiSequenceSystem
    from sdvo_tpu_torch.parallel.multi_seq import multi_chunk_fn, stack_states, unstack_states

    ms = MultiSequenceSystem(bench_config(), 2, supersteps_per_chunk=supersteps, device=device)
    ms.bootstrap([s[:2] for s in pair])  # raises unless both bootstrap on their first two frames
    device, per, fn = ms.groups[0][0], ms.period, multi_chunk_fn(ms.vo)
    if around is None:
        around = lambda k: contextlib.nullcontext()  # noqa: E731
    else:
        fn = fn.eager
    n = supersteps * per
    results = []
    for k, order in enumerate(orders):
        state, outs = stack_states([ms.subs[i].state for i in order]), []
        with around(k), deterministic_on(device):
            for c in range(n_chunks):
                imgs = np.stack([np.stack(pair[i][2 + c * n:2 + (c + 1) * n]) for i in order])
                imgs = imgs.astype(np.float32).reshape(2, supersteps, per, *imgs.shape[2:])
                imgs = np.ascontiguousarray(imgs.transpose(1, 0, 2, 3, 4))  # (C, S, per, H, W)
                state, out = fn(state, torch.from_numpy(imgs).to(device))
                outs.append(out)
        finals = unstack_states(state, 2)
        by_seq = [None, None]
        for slot, i in enumerate(order):
            by_seq[i] = [x[:, slot] for o in outs for x in _bits(o)] + _bits(finals[slot])
        results.append(by_seq)
    return results


def same_bits(xs, ys) -> bool:
    """Whether two lists of arrays hold the same bits (NaNs too)."""
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes() for x, y in zip(xs, ys))


def run_isolation(seqs):
    """Each sequence of ``MultiSequenceSystem`` owns its map: sequence 0 gets
    the same bits beside sequence 1 as beside sequence 2 (S = 2, two joint
    chunks), and, bootstrapped once, the same frame outputs and final state
    in slot 1 as in slot 0 (``joint_by_slot``): no op of the vmapped
    superstep rounds a member by its place in the batch."""
    from sdvo_tpu_torch.parallel import MultiSequenceSystem

    def run(pair):
        ms = MultiSequenceSystem(bench_config(), 2, supersteps_per_chunk=ISO_SUPERSTEPS)
        return ms.run([s[:ISO_FRAMES] for s in pair])

    a, b = run([seqs[0], seqs[1]]), run([seqs[0], seqs[2]])
    same = np.array_equal(np.asarray(a[0]["trajectory"]), np.asarray(b[0]["trajectory"]))
    in0, in1 = joint_by_slot([seqs[0], seqs[1]], ISO_SUPERSTEPS, 2)
    differ = [sum(not same_bits([x], [y]) for x, y in zip(in0[i], in1[i])) for i in range(2)]
    print(f"isolation ({ISO_FRAMES} frames, S = 2): sequence 0 beside sequences 1 and 2: "
          f"{'the same bits' if same else 'DIFFERENT bits'}; sequences 0 and 1 swapped after the "
          f"bootstrap: {differ[0]} and {differ[1]} of {len(in0[0])} output and state arrays differ "
          f"by their slot", flush=True)
    _require(same, "a sequence's result depends on another sequence of its batch")
    _require(differ == [0, 0], "a sequence's outputs changed with its slot in the batch")


# the shard axis at the SCALING_MP.json workload: K keyframes, P points each
# seen by OBS consecutive keyframes, ITERS LM iterations, float32 on the card
SHARD_K, SHARD_P, SHARD_OBS, SHARD_ITERS, SHARD_S = 16, 32768, 4, 4, 4
PG_N, PG_LOOPS, PG_ITERS = 512, 32, 10  # a KITTI sequence's keyframe chain and its loop closures
KITTI_CAM = (721.5377, 721.5377, 609.5593, 172.854)  # fx, fy, cx, cy of the workload (KITTI)
# 4 shards against 1 (another summation order): poses in metres and radians, chi² relative
SHARD_POSE_TOL, SHARD_CHI_TOL = 1e-4, 1e-4
# the card (float32) against the port on the CPU in float64, same problem and shards (on
# the CPU in float32 the gap is 6.7e-6 m, 2.2e-7 rad and 5.0e-7 of chi²)
F64_POSE_TOL, F64_CHI_TOL = 1e-4, 1e-5
REFINE_TOL = 0.05  # the refine keeps the BA window's relative poses (m, rad), as test_pose_graph.py holds
# the pose graph, 4 edge shards against 1, float32: camera centres (m), rotations (rad) and chi²
# (relative). Around a 628 m loop the LM ends in a flat valley (on the CPU chi² 0.010880 after 10
# iterations in float32, 0.010862 in float64, whose poses lie up to 2.8 m away), where another
# summation order accepts other steps: 4.2 cm and 4.0e-4 rad apart on the card
PG_SHARD_POSE_TOL, PG_SHARD_ROT_TOL, PG_SHARD_CHI_TOL = 0.1, 1e-3, 1e-3
SYM_TOL = 1e-4  # JᵀWJ's asymmetry relative to its largest entry: float32 products summed in another order


def shard_ba_problem(seed: int = 0):
    """The workload of ``tools/bench_scaling_mp.py`` (SCALING_MP.json): 16
    keyframes exp([0.3k, 0.01k, 0.08k, 0, 0.01k, 0]), 32,768 points uniform
    in [−10, 10] × [−5, 5] × [8, 40] m, each seen by 4 keyframes drawn at
    random with 0.3 px of noise (observations behind a camera invalid);
    the solve starts from the true poses and the points moved by 0.1 m,
    keyframes 0 and 1 fixed. numpy float64."""
    import torch

    from sdvo_tpu_torch.geometry import se3

    g = np.random.default_rng(seed)
    K, P, M = SHARD_K, SHARD_P, SHARD_OBS
    fx, fy, cx, cy = KITTI_CAM
    k = np.arange(K, dtype=np.float64)
    tau = np.stack([0.3 * k, 0.01 * k, 0.08 * k, 0 * k, 0.01 * k, 0 * k], -1)
    T = se3.exp(torch.tensor(tau))
    R, t = T.rotation.numpy(), T.translation.numpy()
    pts = g.uniform([-10, -5, 8], [10, 5, 40], (P, 3))
    cam = np.argsort(g.random((P, K)), axis=1)[:, :M].reshape(-1)
    pid = np.repeat(np.arange(P), M)
    pc = np.einsum("mij,mj->mi", R[cam], pts[pid]) + t[cam]
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1) + g.normal(0, 0.3, (P * M, 2))
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    return dict(R=R, t=t, pts=pts + g.normal(0, 0.1, pts.shape), cam=cam.astype(np.int32),
                pid=pid.astype(np.int32), uv=uv, valid=pc[:, 2] > 0.1, fixed=fixed)


def _ba_inputs(prob, shards: int, devices, dtype, group_rank=None):
    """(poses, the positional arguments after them, mesh) of
    ``distributed_local_ba`` for ``prob`` cut into ``shards`` landmark shards
    on ``devices`` (one a shard), or, in a process group, this rank's shard
    ``group_rank`` alone on its device (no mesh)."""
    import torch

    from sdvo_tpu_torch.geometry.se3 import SE3
    from sdvo_tpu_torch.parallel import make_vo_mesh, shard_observations

    s_cam, s_pt, s_uv, s_valid, s_table, s_points = shard_observations(
        prob["cam"], prob["pid"], prob["uv"], prob["valid"], SHARD_P, shards, SHARD_OBS)
    pts = np.where((s_points >= 0)[..., None], prob["pts"][np.maximum(s_points, 0)], 0.0)
    arrays = [pts, s_cam, s_pt, s_uv, s_valid, s_table]
    mesh = make_vo_mesh(num_shard=shards, devices=devices)
    if group_rank is not None:
        arrays = [a[group_rank:group_rank + 1] for a in arrays]
        mesh = None
    dev = torch.device(devices[0])
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    t[0] = t[0].to(dtype)
    poses = SE3(torch.from_numpy(prob["R"]).to(dev, dtype), torch.from_numpy(prob["t"]).to(dev, dtype))
    return poses, (*t, torch.from_numpy(prob["fixed"]).to(dev), *KITTI_CAM), mesh


def run_dist_ba(prob, shards: int, devices, dtype, iterations: int = SHARD_ITERS, group_rank=None):
    """``distributed_local_ba`` on ``prob`` (``_ba_inputs``)."""
    from sdvo_tpu_torch.parallel import distributed_local_ba

    poses, args, mesh = _ba_inputs(prob, shards, devices, dtype, group_rank)
    return distributed_local_ba(poses, *args, mesh=mesh, num_cams=SHARD_K, iterations=iterations)


def run_ba_refine(prob, shards: int, device, dtype, older: int = 4):
    """``ba_with_pose_graph_refine``: the window of ``prob`` after ``older``
    keyframes that continue its path backwards, its BA on ``shards``
    landmark shards, then the pose graph over the whole trajectory on as
    many edge shards."""
    import torch

    from sdvo_tpu_torch.geometry import se3
    from sdvo_tpu_torch.geometry.se3 import SE3
    from sdvo_tpu_torch.parallel import ba_with_pose_graph_refine

    poses, args, mesh = _ba_inputs(prob, shards, [device] * shards, dtype)
    k = torch.arange(-older, 0, dtype=torch.float64)
    pre = se3.exp(torch.stack([0.3 * k, 0.01 * k, 0.08 * k, 0 * k, 0.01 * k, 0 * k], -1))
    poses_all = SE3(torch.cat([pre.rotation.to(device, dtype), poses.rotation]),
                    torch.cat([pre.translation.to(device, dtype), poses.translation]))
    return ba_with_pose_graph_refine(poses_all, older, args, mesh=mesh, num_shards=shards, num_cams=SHARD_K,
                                     iterations=SHARD_ITERS)


def pose_graph_problem(seed: int = 1):
    """``PG_N`` keyframes around a circle of 100 m (1.23 m apart), world →
    camera, facing forward; the odometry chain integrated with 2 cm and
    2 mrad of noise a step (the initial poses, drifted) and ``PG_LOOPS``
    exact loop edges across the closure (information 10·I). numpy float64."""
    import torch

    from sdvo_tpu_torch.geometry import se3
    from sdvo_tpu_torch.geometry.se3 import SE3

    g = np.random.default_rng(seed)
    N = PG_N
    th = 2.0 * np.pi * np.arange(N) / N
    c = np.stack([100.0 * np.cos(th), 100.0 * np.sin(th), np.zeros(N)], -1)
    fwd = np.stack([-np.sin(th), np.cos(th), np.zeros(N)], -1)
    up = np.broadcast_to([0.0, 0.0, 1.0], (N, 3))
    R = np.stack([np.cross(fwd, up), -up, fwd], 1)
    gt = SE3(torch.tensor(R), -torch.einsum("nij,nj->ni", torch.tensor(R), torch.tensor(c)))
    pick = lambda T, i: SE3(T.rotation[i], T.translation[i])  # noqa: E731
    Z = pick(gt, slice(1, None)).compose(pick(gt, slice(None, -1)).inverse())
    eps = torch.tensor(np.concatenate([g.normal(0, 0.02, (N - 1, 3)), g.normal(0, 0.002, (N - 1, 3))], -1))
    Zn = se3.exp(eps).compose(Z)
    Rs, ts = [gt.rotation[0]], [gt.translation[0]]
    for k in range(N - 1):
        Rs.append(Zn.rotation[k] @ Rs[-1])
        ts.append(Zn.rotation[k] @ ts[-1] + Zn.translation[k])
    j = np.arange(PG_LOOPS)
    i = N - PG_LOOPS + j
    Zl = pick(gt, torch.tensor(i)).compose(pick(gt, torch.tensor(j)).inverse())
    eye6 = np.eye(6)
    edges = (np.r_[np.arange(1, N), i].astype(np.int32), np.r_[np.arange(N - 1), j].astype(np.int32),
             np.concatenate([Zn.rotation.numpy(), Zl.rotation.numpy()]),
             np.concatenate([Zn.translation.numpy(), Zl.translation.numpy()]),
             np.concatenate([np.broadcast_to(eye6, (N - 1, 6, 6)), np.broadcast_to(10.0 * eye6, (PG_LOOPS, 6, 6))]),
             np.ones(N - 1 + PG_LOOPS, bool))
    return dict(R=torch.stack(Rs).numpy(), t=torch.stack(ts).numpy(), edges=edges,
                R_gt=gt.rotation.numpy(), t_gt=gt.translation.numpy())


def run_pose_graph(prob, shards: int, device, dtype, iterations: int = PG_ITERS):
    """``optimize_pose_graph`` (one shard) or ``distributed_pose_graph`` over
    ``shards`` edge shards on ``device``."""
    import torch

    from sdvo_tpu_torch.geometry.se3 import SE3
    from sdvo_tpu_torch.parallel import PoseGraphEdges, distributed_pose_graph, make_vo_mesh
    from sdvo_tpu_torch.parallel import optimize_pose_graph
    from sdvo_tpu_torch.parallel.pose_graph import shard_edges

    edges = PoseGraphEdges(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in prob["edges"]))
    edges = edges._replace(R_meas=edges.R_meas.to(dtype), t_meas=edges.t_meas.to(dtype),
                           info=edges.info.to(dtype))
    poses = SE3(torch.from_numpy(prob["R"]).to(device, dtype), torch.from_numpy(prob["t"]).to(device, dtype))
    fixed = torch.zeros(PG_N, dtype=torch.bool, device=device)
    fixed[0] = True
    if shards == 1:
        return optimize_pose_graph(poses, edges, fixed, num_poses=PG_N, iterations=iterations)
    mesh = make_vo_mesh(num_shard=shards, devices=[device] * shards)
    return distributed_pose_graph(poses, shard_edges(edges, shards), fixed, mesh=mesh, num_poses=PG_N,
                                  iterations=iterations)


def _pose_gap(a, b):
    """(largest camera-centre distance in metres, largest rotation angle in
    radians) between two pose batches."""
    Ra, ta = (x.detach().cpu().double().numpy() for x in a)
    Rb, tb = (x.detach().cpu().double().numpy() for x in b)
    ca, cb = -np.einsum("kji,kj->ki", Ra, ta), -np.einsum("kji,kj->ki", Rb, tb)
    M = np.einsum("kji,kjl->kil", Ra, Rb)  # Raᵀ Rb; its skew part is sin θ · axis (angles below π/2)
    s = 0.5 * np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return float(np.linalg.norm(ca - cb, axis=-1).max()), float(np.arcsin(np.clip(np.linalg.norm(s, axis=-1), 0, 1)).max())


def _sync_ms(fn, n: int = 3):
    """Median wall ms of ``n`` calls of ``fn``, each ended by a synchronize."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def run_shard_axis(card: str):
    """The ``shard`` axis on the card: the distributed Schur BA at the
    SCALING_MP.json workload with 1 and 4 in-process shards on ``cuda:0``
    (4 against 1, two 4-shard runs bit for bit, chi² not increasing over
    the LM, the card against the port on the CPU in float64), the same
    solve through a one-rank NCCL group formed by ``initialize_from_env``
    (the bits of the in-process single shard), and the pose graph at
    ``PG_N`` keyframes with 1 and 4 edge shards (4 against 1, the loop
    pulling the chain's end onto the truth). Prints ms an LM iteration, the
    reduction's share of it, the payload bytes and the card."""
    import socket

    import torch

    from sdvo_tpu_torch.parallel import dist_ba, distributed

    f32 = torch.float32
    card_dev = "cuda:0"
    payload = dist_ba.payload_floats(SHARD_K)
    payload_bytes = 4 * payload
    _require(payload_bytes == 20736, f"the reduction's payload is {payload_bytes} B at K = {SHARD_K}, not 20,736")
    prob = shard_ba_problem()
    one = run_dist_ba(prob, 1, [card_dev], f32)
    four = run_dist_ba(prob, SHARD_S, [card_dev] * SHARD_S, f32)
    four_again = run_dist_ba(prob, SHARD_S, [card_dev] * SHARD_S, f32)
    same = all(torch.equal(a, b) for a, b in zip((*four[0], *four[1:]), (*four_again[0], *four_again[1:])))
    dc, dr = _pose_gap(four[0], one[0])
    dchi = abs(float(four[2]) - float(one[2])) / float(one[2])
    chis = [float(run_dist_ba(prob, 1, [card_dev], f32, iterations=n)[2]) for n in range(1, SHARD_ITERS)]
    chis.append(float(one[2]))
    ms_one = _sync_ms(lambda: run_dist_ba(prob, 1, [card_dev], f32)) / SHARD_ITERS
    ms_four = _sync_ms(lambda: run_dist_ba(prob, SHARD_S, [card_dev] * SHARD_S, f32)) / SHARD_ITERS
    parts = [torch.randn(payload, device=card_dev) for _ in range(SHARD_S)]
    scalars = [torch.randn((), device=card_dev) for _ in range(SHARD_S)]
    reps = 200
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        distributed.shard_sum(parts)
        distributed.shard_sum(scalars)
    stop.record()
    torch.cuda.synchronize()
    reduce_ms = start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    ref = run_dist_ba(prob, SHARD_S, ["cpu"] * SHARD_S, torch.float64)
    cpu_s = time.perf_counter() - t0
    fc, fr = _pose_gap(four[0], ref[0])
    fchi = abs(float(four[2]) - float(ref[2])) / float(ref[2])
    print(f"shard axis ({card}): distributed BA, K = {SHARD_K}, P = {SHARD_P}, {SHARD_OBS} observations a "
          f"point, {SHARD_ITERS} LM iterations, float32: {ms_one:.3f} ms an iteration with 1 shard, "
          f"{ms_four:.3f} ms with {SHARD_S} in-process shards on {card_dev} (a call's wall time over its "
          f"iterations); the reduction (payload + chi², {SHARD_S} shards summed in order on one card) "
          f"{reduce_ms:.4f} ms an iteration, {100 * reduce_ms / ms_four:.2f} % of it; payload "
          f"{payload} floats = {payload_bytes} B an iteration; chi² over the LM {[round(c, 3) for c in chis]}",
          flush=True)
    print(f"shard axis: {SHARD_S} shards against 1: centres {dc:.3e} m, rotations {dr:.3e} rad, chi² "
          f"{dchi:.3e} relative (tolerances {SHARD_POSE_TOL:g}, {SHARD_CHI_TOL:g}); two {SHARD_S}-shard runs: "
          f"{'the same bits' if same else 'DIFFERENT bits'}; the card against the CPU in float64 "
          f"({cpu_s:.1f} s there): centres {fc:.3e} m, rotations {fr:.3e} rad, chi² {fchi:.3e} relative "
          f"(tolerances {F64_POSE_TOL:g}, {F64_CHI_TOL:g})", flush=True)
    _require(same, "two 4-shard runs of the distributed BA gave different bits")
    _require(dc < SHARD_POSE_TOL and dr < SHARD_POSE_TOL and dchi < SHARD_CHI_TOL,
             f"4 shards against 1: {dc}, {dr}, {dchi}")
    _require(all(b <= a for a, b in zip(chis, chis[1:])), f"chi² rose over the LM: {chis}")
    _require(fc < F64_POSE_TOL and fr < F64_POSE_TOL and fchi < F64_CHI_TOL,
             f"the card against the CPU in float64: {fc}, {fr}, {fchi}")

    # BASELINE config 5's whole stack: the BA window, then the refine
    older = 4
    refined, _, chi_ba, chi_pg = run_ba_refine(prob, SHARD_S, card_dev, f32, older)
    same_ba = torch.equal(chi_ba, four[2])
    rel = lambda T, a, b: (T[0][b] @ T[0][a].T, T[1][b] - T[0][b] @ T[0][a].T @ T[1][a])  # noqa: E731
    win = max(max(_pose_gap([x[None] for x in rel(refined, older + k - 1, older + k)],
                            [x[None] for x in rel(four[0], k - 1, k)])) for k in range(1, SHARD_K))
    R = refined[0].double()
    ortho = float((R @ R.transpose(1, 2) - torch.eye(3, dtype=R.dtype, device=R.device)).abs().max())
    print(f"shard axis: ba_with_pose_graph_refine over {older} + {SHARD_K} keyframes ({SHARD_S} landmark and "
          f"edge shards): BA chi² {float(chi_ba):.3f} ({'the' if same_ba else 'NOT the'} distributed BA's), "
          f"pose-graph chi² {float(chi_pg):.4g}; the window's relative poses move {win:.3e} (m or rad) from "
          f"the BA's (tolerance {REFINE_TOL:g}); rotations orthonormal to {ortho:.1e}", flush=True)
    _require(same_ba, "the refine's BA stage differs from distributed_local_ba on the same shards")
    _require(bool(torch.isfinite(chi_pg)) and win < REFINE_TOL and ortho < 1e-5,
             f"ba_with_pose_graph_refine: chi² {chi_pg}, window {win}, orthonormality {ortho}")

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"SDVO_COORDINATOR": f"127.0.0.1:{port}", "SDVO_NUM_PROCESSES": "1", "SDVO_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        _require(distributed.initialize_from_env(), "initialize_from_env formed no group")
        info, backend = distributed.runtime_info(), torch.distributed.get_backend()
        grouped = run_dist_ba(prob, 1, [card_dev], f32, group_rank=0)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k in env:
            os.environ.pop(k)
    same_group = all(torch.equal(a, b) for a, b in zip((*grouped[0], *grouped[1:]), (*one[0], *one[1:])))
    print(f"shard axis: a one-rank {backend} group ({info}) gives {'the same' if same_group else 'DIFFERENT'} "
          f"bits as the in-process single shard; NCCL puts no two ranks on one card, so no scaling figure",
          flush=True)
    _require(backend == "nccl" and info["platform"] == "gpu" and info["process_count"] == 1,
             f"the group: {backend}, {info}")
    _require(same_group, "the one-rank NCCL group's result differs from the in-process single shard")

    pg = pose_graph_problem()
    pg_one = run_pose_graph(pg, 1, card_dev, f32)
    pg_four = run_pose_graph(pg, SHARD_S, card_dev, f32)
    gc, gr = _pose_gap(pg_four[0], pg_one[0])
    gchi = abs(float(pg_four[1]) - float(pg_one[1])) / float(pg_one[1])
    gt = (torch.from_numpy(pg["R_gt"]), torch.from_numpy(pg["t_gt"]))
    end = lambda T: _pose_gap((T[0][-1:], T[1][-1:]), (gt[0][-1:], gt[1][-1:]))[0]  # noqa: E731
    end0, end1 = end((torch.from_numpy(pg["R"]), torch.from_numpy(pg["t"]))), end(pg_one[0])
    pg_ms = _sync_ms(lambda: run_pose_graph(pg, 1, card_dev, f32)) / PG_ITERS
    pg_ms4 = _sync_ms(lambda: run_pose_graph(pg, SHARD_S, card_dev, f32)) / PG_ITERS
    print(f"shard axis ({card}): pose graph, N = {PG_N} keyframes, {PG_N - 1} odometry + {PG_LOOPS} loop "
          f"edges, H {6 * PG_N}², {PG_ITERS} iterations, float32: {pg_ms:.3f} ms an iteration with 1 shard, "
          f"{pg_ms4:.3f} ms with {SHARD_S} edge shards; {SHARD_S} against 1: centres {gc:.3e} m, rotations "
          f"{gr:.3e} rad, chi² {gchi:.3e} relative (tolerances {PG_SHARD_POSE_TOL:g}, {PG_SHARD_ROT_TOL:g}, "
          f"{PG_SHARD_CHI_TOL:g}); the chain's end {end0:.3f} m from the truth before, {end1:.3f} m after; "
          f"chi² {float(pg_one[1]):.6g}, {float(pg_four[1]):.6g}", flush=True)
    _require(gc < PG_SHARD_POSE_TOL and gr < PG_SHARD_ROT_TOL and gchi < PG_SHARD_CHI_TOL,
             f"pose graph, 4 shards against 1: {gc}, {gr}, {gchi}")
    _require(end1 < 0.5 * end0, f"the loop edges did not pull the end toward the truth: {end0} → {end1}")
    _require(all(torch.isfinite(x).all() for x in (*pg_one[0], pg_one[1], *pg_four[0])), "non-finite poses")


DIAG_FRAMES = 2 + 6  # the bootstrap and six tracked frames


def run_diagnostics(card: str, frames):
    """``System`` on the card with visualization on and saving_type "None",
    the diagnostics going to an in-memory sink: every alignment level and
    pose polish emits finite residuals and weights and a symmetric JᵀWJ;
    neither PIL nor matplotlib is imported."""
    import tempfile

    from sdvo_tpu_torch.config import load_config
    from sdvo_tpu_torch.optim.optimizer import set_diagnostics_sink
    from sdvo_tpu_torch.pipeline.system import FrameResult, System

    before = {m for m in ("PIL", "matplotlib") if m in sys.modules}
    got = []
    with tempfile.TemporaryDirectory() as out:
        cfg = load_config(overrides={
            "initialization": {"disparity_threshold": 3, "threshold_gradient_magnitude": 20},
            "visualization": {"enable_visualization": True, "saving_type": "None"},
            "file_paths": {"output_dir": out},
        })
        system = System(cfg)  # the card by default
        _require(system.device.type == "cuda", f"System chose {system.device}, not the card")
        set_diagnostics_sink(lambda *a: got.append(a))
        try:
            t0 = time.perf_counter()
            results = [system.add_image(frames[i].astype(np.float32), float(i)) for i in range(DIAG_FRAMES)]
            seconds = time.perf_counter() - t0
        finally:
            set_diagnostics_sink(None)
    _require(FrameResult.FAILED not in results, f"diagnostics run: {[r.name for r in results]}")
    tracked = DIAG_FRAMES - 2
    tags = [c[0] for c in got]
    n_align, n_pose = tags.count("image_alignment"), tags.count("pose_refine")
    worst = 0.0
    for tag, r, w, vis, H in got:
        _require(np.isfinite(r).all() and np.isfinite(w).all() and np.isfinite(H).all(),
                 f"{tag}: non-finite diagnostics")
        _require(H.shape == (6, 6) and vis.dtype == bool and vis.any(), f"{tag}: H {H.shape}, visible {vis.sum()}")
        asym = float(np.abs(H - H.T).max() / max(np.abs(H).max(), 1e-30))
        worst = max(worst, asym)
        _require(asym < SYM_TOL, f"{tag}: JᵀWJ not symmetric ({asym})")
    print(f"diagnostics ({card}): System with visualization on over {DIAG_FRAMES} frames in {seconds:.2f} s: "
          f"{n_align} image_alignment and {n_pose} pose_refine emissions, all finite, JᵀWJ symmetric "
          f"to {worst:.2e} of its largest entry; PIL and matplotlib not imported", flush=True)
    _require(n_align == system.num_levels * tracked, f"{n_align} alignment emissions for {tracked} frames")
    _require(n_pose == tracked, f"{n_pose} pose-polish emissions for {tracked} frames")
    _require({m for m in ("PIL", "matplotlib") if m in sys.modules} == before,
             "the diagnostics phase imported PIL or matplotlib")


STREAM_F = 8  # frames a chunk of the streaming path
STREAM_CHUNKS = 3  # against the one reference keyframe; the first warms up
STREAM_LEVELS = 4
STREAM_DTAU = (0.08, 0.01, 0.05, 0.001, 0.004, 0.0008)  # tests/test_streaming.py's motion a frame
STREAM_STEP = 0.5  # its scale here: frame 24 still sees 80 % of the features
STREAM_MIN_SEEN = 0.80
STREAM_GATES = (0.06, 0.01)  # m and rad a frame, the JAX test's gates


def streaming_inputs(scene, cfg, device):
    """The tracker's fixed inputs on ``device``: the reference keyframe's
    pyramid, the alignment features (N = ``max_features_per_frame``, the
    first ``max_reprojection_matches`` of them matched) and a bank of
    ``max_filters`` filters seeded at the keyframe with 7×7 patches."""
    import torch

    from sdvo_tpu_torch.align.image_alignment import AlignFeatures
    from sdvo_tpu_torch.depth.filter import init_filters
    from sdvo_tpu_torch.image.interp import extract_patches
    from sdvo_tpu_torch.image.pyramid import build_pyramid

    alg = cfg.algorithm
    N, M = alg.max_features_per_frame, alg.max_reprojection_matches
    pyr = build_pyramid(torch.from_numpy(scene.ref).to(device), STREAM_LEVELS)
    feats = AlignFeatures(torch.from_numpy(scene.uv).to(device), torch.zeros(N, dtype=torch.int32, device=device),
                          torch.from_numpy(scene.points).to(device), torch.ones(N, dtype=torch.bool, device=device))
    fuv = torch.from_numpy(scene.filter_uv).to(device)
    patches, ok = extract_patches(pyr.base_image, fuv, 7)
    bank = init_filters(fuv, torch.from_numpy(scene.filter_bearing).to(device), patches, 0, 8.0, 2.0, 0, ok)
    return dict(host_pyr=[im[None] for im in pyr.images], host_grad0=pyr.base_gradient, feats=feats,
                uv_match=feats.uv_host[:M], match_valid=torch.ones(M, dtype=torch.bool, device=device),
                filters=bank)


def track_stream(tracker, scene, inputs, cam, count_syncs_in=None, eager=False):
    """The chunks of ``scene`` in order, each from the last one's carry, its
    frames staged on the tracker's device first (so that a chunk copies
    nothing from the host); ``eager`` calls ``track_chunk_eager`` in place
    of ``track_chunk``. Returns (each chunk's outputs, the last carry, each
    chunk's seconds, each chunk's launches, the host syncs of chunk
    ``count_syncs_in`` (``host_syncs``) or None)."""
    import torch

    from sdvo_tpu_torch.geometry.se3 import SE3

    dev = tracker.device
    track = tracker.track_chunk_eager if eager else tracker.track_chunk
    T0 = SE3.identity(device=dev)
    T_cur, T_prev, bank = T0, T0, inputs["filters"]
    kf_counter = torch.zeros((), dtype=torch.int32, device=dev)
    outs, seconds, launches, syncs = [], [], [], None
    for c in range(STREAM_CHUNKS):
        images = torch.from_numpy(np.ascontiguousarray(scene.frames[c * STREAM_F:(c + 1) * STREAM_F])).to(dev)

        def chunk():
            return track(images, inputs["host_pyr"], inputs["host_grad0"], inputs["feats"], inputs["uv_match"],
                         inputs["match_valid"], T_cur, T_prev, bank, cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                         kf_counter)

        if dev.type == "cuda":
            torch.cuda.synchronize()
        with LaunchCount() as counts:
            t0 = time.perf_counter()
            if c == count_syncs_in:
                (carry, out), syncs = host_syncs(chunk)
            else:
                carry, out = chunk()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        launches.append(counts)
        outs.append(out)
        T_cur, T_prev, bank = carry
    return outs, carry, seconds, launches, syncs


def _stream_digest(outs, carry) -> str:
    import torch

    leaves = [x for o in outs for x in o] + [carry.T_cur_ref.rotation, carry.T_cur_ref.translation,
                                             carry.T_prev_ref.rotation, carry.T_prev_ref.translation, *carry.filters]
    h = hashlib.sha256()
    for x in leaves:
        h.update(x.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _projections(points, rotations, translations, cam):
    p = np.einsum("fij,nj->fni", rotations.astype(np.float64), points.astype(np.float64)) + translations[:, None]
    return np.stack([cam["fx"] * p[..., 0] / p[..., 2] + cam["cx"], cam["fy"] * p[..., 1] / p[..., 2] + cam["cy"]], -1)


def _stream_gates(name, outs, carry, scene, failures):
    """Every frame within ``STREAM_GATES`` of the truth; the carry is the
    last frame's outputs. Returns (rotations, translations) as numpy."""
    import torch

    R = np.concatenate([o.rotations.cpu().numpy() for o in outs])
    t = np.concatenate([o.translations.cpu().numpy() for o in outs])
    worst_t, worst_r = 0.0, 0.0
    for i, T in enumerate(scene.T_true):
        worst_t = max(worst_t, float(np.linalg.norm(t[i] - T[:3, 3])))
        worst_r = max(worst_r, float(np.arccos(np.clip((np.trace(R[i].T.astype(np.float64) @ T[:3, :3]) - 1) / 2,
                                                       -1, 1))))
    if not (worst_t < STREAM_GATES[0] and worst_r < STREAM_GATES[1]):
        failures.append(f"streaming path on {name}: worst frame {worst_t:.4f} m, {worst_r:.5f} rad off the truth")
    last = outs[-1]
    if not (torch.equal(carry.T_cur_ref.rotation, last.rotations[-1])
            and torch.equal(carry.T_cur_ref.translation, last.translations[-1])
            and torch.equal(carry.T_prev_ref.translation, last.translations[-2])):
        failures.append(f"streaming path on {name}: the final carry is not the last frame's outputs")
    return R, t, worst_t, worst_r


def run_streaming(card: str, failures):
    """``StreamingTracker`` on the card at the bench's geometry and
    capacities: a plane at 10 m (KITTI intrinsics, 1241×376, four levels),
    N = 256 features, M = 150 matches, C = 512 filters seeded at the
    reference keyframe, three chunks of ``STREAM_F`` frames against that one
    keyframe, each from the last one's carry. Gates: every frame within
    ``STREAM_GATES`` of the truth, on the card and on the CPU (the plain
    versions of the kernels); the carry is the last frame's outputs; two card
    runs give the same bits; K1 four launches a frame, K2 and K4 one, K3
    none, no plain version on a CUDA tensor. Prints frames/s, the launches
    of a chunk, K2's converged share, the converged filters' depth error, the
    card-CPU gap and the host syncs of one chunk with the line that made
    each. Returns the launches of the first run."""
    import torch

    from sdvo_tpu_torch.align.image_alignment import SparseImageAlign
    from sdvo_tpu_torch.dataio.synthetic import KITTI_CAMERA, render_plane_track
    from sdvo_tpu_torch.geometry.se3 import SE3
    from sdvo_tpu_torch.pipeline.streaming import StreamingTracker

    t_phase = time.perf_counter()
    cfg = bench_config()
    alg = cfg.algorithm
    n_frames = STREAM_CHUNKS * STREAM_F
    dtau = np.asarray(STREAM_DTAU) * STREAM_STEP
    scene = render_plane_track(np.random.default_rng(0), KITTI_CAMERA, dtau, n_frames, alg.max_features_per_frame,
                               alg.max_filters, margin=24.0, tex_size=4096, blur=13)
    cam = KITTI_CAMERA
    seen = _projections(scene.points, scene.T_true[-1][None, :3, :3], scene.T_true[-1][None, :3, 3], cam)[0]
    seen_share = float(np.mean((seen[:, 0] >= 0) & (seen[:, 0] < cam["width"]) & (seen[:, 1] >= 0)
                               & (seen[:, 1] < cam["height"])))
    _require(seen_share >= STREAM_MIN_SEEN, f"frame {n_frames} sees {seen_share:.2f} of the features")

    def tracker(device):
        aligner = SparseImageAlign(patch_size=alg.patch_size_image_alignment, min_level=0,
                                   max_level=STREAM_LEVELS - 1)
        return StreamingTracker(aligner, levels=STREAM_LEVELS, fa_patch=alg.patch_size_feature_alignment,
                                device=device)

    card_tracker = tracker(None)  # the card by default
    _require(card_tracker.device.type == "cuda", f"StreamingTracker chose {card_tracker.device}, not the card")
    inputs = streaming_inputs(scene, cfg, card_tracker.device)
    outs, carry, seconds, counts, _ = track_stream(card_tracker, scene, inputs, cam)
    R, t, worst_t, worst_r = _stream_gates("the card", outs, carry, scene, failures)
    graphs = card_tracker.graph.graphs
    warm = warmup_launches(graphs.values())
    want = {"lm_align_level": 4 * STREAM_F, "fa_align_batch": STREAM_F, "pose_refine": 0, "depth_scores": STREAM_F}
    # the first chunk's count holds the capture's warm-up too
    per_chunk = [{k: n - (warm[k] if i == 0 else 0) for k, n in c.launches.items()} for i, c in enumerate(counts)]
    for got, c in zip(per_chunk, counts):
        if got != want:
            failures.append(f"streaming path: launches of a chunk {got}, not 4/1/0/1 a frame")
        if any(c.plain_on_cuda.values()):
            failures.append(f"streaming path: plain versions ran on CUDA tensors: {c.plain_on_cuda}")
    launches = {k: sum(p[k] for p in per_chunk) for k in per_chunk[0]}
    if len(graphs) != 1 or next(iter(graphs.values())).captured_launches != want:
        failures.append(f"streaming path: {len(graphs)} graphs for one chunk length: "
                        f"{graph_line({'stream': g for g in graphs.values()})}")

    outs2, carry2, _, _, syncs = track_stream(card_tracker, scene, inputs, cam, count_syncs_in=1)
    d1, d2 = _stream_digest(outs, carry), _stream_digest(outs2, carry2)
    if d1 != d2:
        failures.append(f"streaming path: two card runs gave different bits ({d1}, {d2})")
    if syncs:
        failures.append(f"streaming path: host syncs inside a replayed chunk: {syncs}")
    outs_e, carry_e, seconds_e, _, syncs_e = track_stream(card_tracker, scene, inputs, cam, count_syncs_in=1,
                                                          eager=True)
    d_e = _stream_digest(outs_e, carry_e)
    if d_e != d1:
        failures.append(f"streaming path: the graphed chunks ({d1}) and the eager loop ({d_e}) differ")
    T0 = SE3.identity(device=card_tracker.device)
    frames0 = torch.from_numpy(np.ascontiguousarray(scene.frames[:STREAM_F])).to(card_tracker.device)
    with LaunchCount() as replay_count:
        prof, events, _ = profiled_launches(lambda: card_tracker.track_chunk(
            frames0, inputs["host_pyr"], inputs["host_grad0"], inputs["feats"], inputs["uv_match"],
            inputs["match_valid"], T0, T0, inputs["filters"], cam["fx"], cam["fy"], cam["cx"], cam["cy"], 0))
    if prof != want or replay_count.launches != want:
        failures.append(f"streaming path: a replay counts {replay_count.launches} launches and torch.profiler "
                        f"{prof}, not {want}")

    t_cpu = time.perf_counter()
    cpu_tracker = tracker("cpu")
    outs_c, carry_c, _, _, _ = track_stream(cpu_tracker, scene, streaming_inputs(scene, cfg, cpu_tracker.device), cam)
    cpu_s = time.perf_counter() - t_cpu
    Rc, tc, worst_tc, worst_rc = _stream_gates("the CPU", outs_c, carry_c, scene, failures)
    gap = float(np.abs(_projections(scene.points, R, t, cam) - _projections(scene.points, Rc, tc, cam)).max())

    fa_conv = float(torch.cat([o.fa_converged for o in outs]).float().mean())
    df_any = torch.stack([o.df_converged.any(0) for o in outs]).any(0).cpu().numpy()
    depth = 1.0 / carry.filters.mu.double().cpu().numpy()
    err = np.abs(depth - scene.filter_depth) / scene.filter_depth
    med_err = float(np.median(err[df_any])) if df_any.any() else float("nan")
    fps = STREAM_F / float(np.median(seconds[1:]))
    fps_eager = STREAM_F / float(np.median(seconds_e[1:]))
    print(f"streaming path ({card}): StreamingTracker at {cam['width']}x{cam['height']}, {STREAM_LEVELS} levels, N "
          f"{alg.max_features_per_frame}, M {alg.max_reprojection_matches}, C {alg.max_filters}; "
          f"{STREAM_CHUNKS} chunks of {STREAM_F} frames against one keyframe, the motion a frame "
          f"{STREAM_STEP} x tests/test_streaming.py's dtau (frame {n_frames} sees {100 * seen_share:.1f} % of "
          f"the features); worst frame {worst_t:.5f} m / {worst_r:.6f} rad on the card, {worst_tc:.5f} m / "
          f"{worst_rc:.6f} rad on the CPU; card vs CPU {gap:.5f} px in projected features (not a gate); "
          f"digests {d1} {d2}, the eager loop {d_e}", flush=True)
    print(f"streaming path frames/s {fps:.2f} through the graph, {fps_eager:.2f} as the eager loop ({card}; median "
          f"of {STREAM_CHUNKS - 1} chunks of {STREAM_F} frames after one warm-up chunk, the frames staged on the "
          f"card first; chunk seconds {[round(s, 4) for s in seconds]}, eager {[round(s, 4) for s in seconds_e]}); "
          f"launches a chunk {per_chunk[0]}, in one replay by torch.profiler {prof} ({events} device events); "
          f"{graph_line({'stream': g for g in graphs.values()})}; K2 converged {100 * fa_conv:.1f} % of the "
          f"matches; {int(df_any.sum())} filters converged, median depth error {100 * med_err:.2f} % against the "
          f"10 m plane; the CPU run {cpu_s:.1f} s", flush=True)
    for name, found in (("a replayed chunk", syncs), ("an eager chunk", syncs_e)):
        where = collections.Counter(found)
        print(f"streaming path host syncs in {name} of {STREAM_F} frames: {len(found)}"
              + "".join(f"\n  {n} x {k}" for k, n in where.most_common()), flush=True)
    print(f"streaming path: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# the port's measurement tools (tools/*_torch.py): each phase runs one at
# the shapes it runs at alone, with the main path's frames
PROFILE_OWN = {  # the port's kernels a call of each profile_system_torch stage: K1, K2, K3, K4
    "chain alone": (0, 0, 0, 0), "pyramid": (0, 0, 0, 0), "alignment (K1 x4)": (4, 0, 0, 0),
    "reprojection (K2)": (0, 1, 0, 0), "pose polish (K3)": (0, 0, 1, 0), "depth filters (K4)": (0, 0, 0, 1),
    "local BA": (0, 0, 0, 0), "tracked frame": (4, 1, 1, 1), "keyframe frame": (4, 1, 1, 1)}
ABLATE_OWN = {  # ... and a frame of each profile_ablate_torch run
    "full chunk": (4, 1, 1, 1), "no BA": (4, 1, 1, 1), "no keyframe extras": (4, 1, 1, 1),
    "no alignment": (0, 1, 1, 1), "no depth filters": (4, 1, 1, 0), "no reprojection/FA/pose": (4, 0, 0, 1)}


def run_bench_multiseq(card: str, seqs, fps_by_s: dict):
    """``tools/bench_multiseq_torch.py`` at its defaults (S = 4 sequences,
    texture seeds 0-3, chunks of 8 supersteps, one warm-up and 2 timed joint
    chunks) on the card: its gates (more than 95 % of the frames ok after the
    warm-up and after the last chunk), every kernel launched and no plain
    version on a CUDA tensor. ``fps_by_s`` holds the multi-sequence phase's
    aggregates, printed beside. Returns the phase's launches."""
    import bench_multiseq_torch as bm

    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    t_phase = time.perf_counter()
    config = bench_config()
    with LaunchCount() as counts:
        subs = bm.bootstrap(seqs, lambda: DeviceSystem(config, supersteps_per_chunk=bm.SUPERSTEPS))
        res = bm.run(subs, seqs, bm.SUPERSTEPS, bm.CHUNKS)
    _require(all(ds.device.type == "cuda" for ds, _ in subs), "bench_multiseq_torch's systems are not on the card")
    print(f"bench_multiseq_torch ({card}): S = {res['sequences']}, {res['value']:.2f} aggregate frames/s, "
          f"{res['per_seq_fps']:.2f} a sequence (timed chunk seconds {[round(x, 4) for x in res['chunk_s']]}, "
          f"warm-up {res['warmup_s']:.2f} s, pool {res['pool_bytes']} B); ok {res['ok_warmup']:.3f} after the "
          f"warm-up, {res['ok_last']:.3f} after the last chunk; the multi-sequence phase's aggregates "
          + ", ".join(f"S = {s}: {v:.2f}" for s, v in fps_by_s.items())
          + f"; launches {counts.launches}; {time.perf_counter() - t_phase:.1f} s", flush=True)
    _require(res["broken"] is None, f"bench_multiseq_torch: {res['broken']}")
    _require(all(n > 0 for n in counts.launches.values()), f"a kernel never launched: {counts.launches}")
    _require(not any(counts.plain_on_cuda.values()), f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    return counts.launches


def _own(row_own: dict) -> tuple:
    return tuple(row_own[k] for k in KERNEL_SYMBOLS)


def run_profile_system(card: str, frames):
    """``tools/profile_system_torch.py`` on the card: the JAX tool's state
    (bench scene, texture 0, ``DeviceSystem(supersteps_per_chunk=1)``, one
    superstep), each stage of the frame step a CUDA graph of 20 chained
    calls, timed over 3 replays; every stage's own-kernel launches a call as
    ``PROFILE_OWN`` says and a finite positive time. Returns the phase's
    launches."""
    import profile_system_torch as ps

    from sdvo_tpu_torch.device import deterministic_on

    t_phase = time.perf_counter()
    with LaunchCount() as counts:
        ds, image = ps.setup(frames[:ps.N_FRAMES], None)
        with deterministic_on(ds.device):
            rows = ps.profile(ds.vo, ds.state, image)
    amort = ps.amortized(rows, ds.scfg.period)
    print(f"profile_system_torch ({card}), device ms / kernels a call ({ps.REPS} chained calls a graph, median "
          f"of {ps.REPLAYS} replays): " + "; ".join(
              f"{r['stage']} {r['ms']:.4f} / {r['kernels']:.1f} {_own(r['own'])}" for r in rows)
          + f"; amortized frame {amort:.4f} ms; the pre-roll's events the profiler dropped "
          f"{[r['profiler_dropped'] for r in rows]}; launches {counts.launches}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    for r in rows:
        _require(np.isfinite(r["ms"]) and r["ms"] > 0, f"profile_system_torch: {r['stage']} took {r['ms']} ms")
        _require(_own(r["own"]) == PROFILE_OWN[r["stage"]],
                 f"profile_system_torch: {r['stage']} launches {r['own']} a call, not {PROFILE_OWN[r['stage']]}")
    _require(not any(counts.plain_on_cuda.values()), f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    return counts.launches


def run_profile_ablate(card: str, frames):
    """``tools/profile_ablate_torch.py`` on the card: the bench scene's
    texture 0, chunks of 8 supersteps, the state after two chunks, chunk 2
    through ``chunk_fn(8)`` in full and with each stage stubbed out, each a
    graph of its own timed over 3 calls; every run's own-kernel launches a
    frame as ``ABLATE_OWN`` says, and the stubs gone afterwards. Returns the
    phase's launches."""
    import profile_ablate_torch as pa

    from sdvo_tpu_torch.device import deterministic_on

    t_phase = time.perf_counter()
    originals = [vars(ns)[attr] for ts in pa.ablations().values() for ns, attr, _ in ts]
    with LaunchCount() as counts:
        ds, state, chunk = pa.setup(frames, None)
        with deterministic_on(ds.device):
            rows = pa.run_ablations(ds.vo, state, chunk, pa.SUPERSTEPS)
    print(f"profile_ablate_torch ({card}), ms a frame (delta from the full chunk) / kernels a frame, "
          f"median of {pa.REPLAYS} calls: " + "; ".join(
              f"{r['run']} {r['ms_frame']:.4f} ({r['delta_ms_frame']:+.4f}) / {r['kernels_frame']:.1f} "
              f"{_own(r['own_frame'])}" for r in rows)
          + f"; the pre-roll's events the profiler dropped {[r['profiler_dropped'] for r in rows]}; "
          f"launches {counts.launches}; {time.perf_counter() - t_phase:.1f} s", flush=True)
    _require([vars(ns)[attr] for ts in pa.ablations().values() for ns, attr, _ in ts] == originals,
             "profile_ablate_torch left a stub in the package")
    for r in rows:
        _require(np.isfinite(r["ms_frame"]) and r["ms_frame"] > 0,
                 f"profile_ablate_torch: {r['run']} took {r['ms_frame']} ms a frame")
        _require(_own(r["own_frame"]) == ABLATE_OWN[r["run"]],
                 f"profile_ablate_torch: {r['run']} launches {r['own_frame']} a frame, not {ABLATE_OWN[r['run']]}")
    _require(not any(counts.plain_on_cuda.values()), f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    return counts.launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [repo, os.path.join(repo, "tools")]
    import bench_multiseq_torch as bm
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences
    from sdvo_tpu_torch.ops import build, selfcheck

    t_start = time.perf_counter()
    device = torch.device("cuda:0")
    card = selfcheck.card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s ({build.LIB_PATH})", flush=True)

    # every sequence rendered up front, before anything is timed, in a pool of
    # processes: texture 0 at the bench protocol's length, whose first frames
    # the other phases take, every texture of the multi-sequence scene, and
    # the textures of bench_multiseq_torch's sequences that it lacks
    n_frames = 2 + N_CHUNKS * SUPERSTEPS_PER_CHUNK * PER
    bm_frames = 2 + (1 + bm.CHUNKS) * bm.SUPERSTEPS * PER + bm.BOOT_SLACK
    bm_seeds = tuple(range(1, bm.SEQS))  # texture 0 is the bench protocol's
    t0 = time.perf_counter()
    bench, *rendered = render_bench_sequences((0,) + MULTI_SEEDS + bm_seeds,
                                              (BENCH_FRAMES,) + (n_frames,) * BATCH + (bm_frames,) * len(bm_seeds),
                                              processes=os.cpu_count() or 1)
    multiseq_seqs = [bench[0][:bm_frames]] + [r[0] for r in rendered[BATCH:]]
    rendered = rendered[:BATCH]
    _require(MULTI_SEEDS[0] == 0 and all(np.array_equal(a, b) for a, b in zip(bench[0], rendered[0][0])),
             "texture 0 rendered at two lengths differs in its first frames")
    rendered[0] = (bench[0][:n_frames], bench[1][:n_frames])
    seqs = [r[0] for r in rendered]
    frames, T_true = rendered[0]
    print(f"{len(seqs)} sequences of {n_frames} frames, {len(bm_seeds)} of {bm_frames} and texture 0 at "
          f"{BENCH_FRAMES} frames (its first {n_frames} the same bits as alone) rendered in "
          f"{time.perf_counter() - t0:.1f} s by {os.cpu_count()} processes", flush=True)

    failures = []
    rows, empty_ms = check_kernels(device, failures)
    check_batched_kernels(device, failures, rows, empty_ms)
    launches, steady_frames, main_ds, main_fps, chunk_replay = run_main_path(card, frames, T_true)
    launches_bench = run_bench_protocol(card, bench[0], bench[1], main_ds)
    del bench
    run_graph_checks(card, frames)
    launches_host, host_frames = run_host_path(card, frames, T_true)
    run_recovery(card, frames)
    launches_long = run_long(card)
    launches_euroc_system, launches_euroc_device = run_euroc(card)
    _, _, eager_ds, eager_fps, _ = run_main_path(card, frames, T_true, "main path, eager loop", eager=True)
    _, _, again_ds, main_fps_again, _ = run_main_path(card, frames, T_true, "main path, second run")
    digests = [trajectory_digest(d.trajectory) for d in (main_ds, again_ds, eager_ds)]
    print(f"main path determinism: the two graphed runs and the eager run give trajectory digests {digests}; "
          f"frames/s {main_fps:.2f} and {main_fps_again:.2f} through the graph, {eager_fps:.2f} as the eager loop "
          f"({card})", flush=True)
    _require(len(set(digests)) == 1, "the main path's runs gave different trajectories")
    launches_multi, multi_steps, multi_replay, multi_warm, multi_fps = run_multi_seq(
        card, seqs, T_true, main_ds, main_fps, main_fps_again)
    main_warm = warmup_launches(vo_graphs(main_ds.vo).values())
    run_isolation(seqs)
    run_shard_axis(card)
    run_diagnostics(card, frames)
    launches_stream = run_streaming(card, failures)
    launches_bench_multiseq = run_bench_multiseq(card, multiseq_seqs, multi_fps)
    launches_profile_system = run_profile_system(card, frames)
    launches_profile_ablate = run_profile_ablate(card, frames)
    _require(not failures, "; ".join(failures))

    kernels = []
    for name, r in rows.items():
        base = name.split("[")[0]
        src, replaces = SOURCES[base]
        # K1's row at the host path's shape counts that path's launches, the
        # batched rows the multi-sequence path's (a frame step: every
        # sequence); K4's extra shapes run on no path, so launch none there
        on_path, n_path, warm = ((launches_host, host_frames, {}) if name == K1_HOST_ROW
                                 else (launches_multi, multi_steps, multi_warm) if name.endswith(f"[S{BATCH}]")
                                 else (launches, steady_frames, main_warm))
        n = on_path[base] if r["on_path"] else 0
        w = warm.get(base, 0) if r["on_path"] else 0
        replay = (None if name == K1_HOST_ROW  # the host path runs frame by frame, no graph
                  else multi_replay[base] if name.endswith(f"[S{BATCH}]")
                  else chunk_replay[base] if r["on_path"] else 0)
        # each kernel's launches in each path's run, counted from 0 just before it
        by_phase = {phase: counts[base] if r["on_path"] else 0
                    for phase, counts in (("main", launches), ("bench", launches_bench),
                                          ("host_path", launches_host),
                                          ("long", launches_long), ("euroc_system", launches_euroc_system),
                                          ("euroc_device", launches_euroc_device),
                                          ("multi_seq", launches_multi), ("streaming", launches_stream),
                                          ("bench_multiseq", launches_bench_multiseq),
                                          ("profile_system", launches_profile_system),
                                          ("profile_ablate", launches_profile_ablate))}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": n, "launches_per_chunk_replay": replay, "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "device_ms": r["device_ms"], "device_ms_cold": r["device_ms_cold"],
                        "launches_warmup": w, "launches_per_frame": (n - w) / n_path, "on_path": r["on_path"],
                        "launches_host_path": launches_host[base] if r["on_path"] else 0,
                        "launches_streaming": launches_stream[base] if r["on_path"] else 0,
                        "launches_by_phase": by_phase})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
