#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sdvo_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Requires a CUDA card and prints its name and power limit.
2. Builds the hand-written kernels from ``sdvo_tpu_torch/csrc`` (nvcc, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K1: 256 features at all four levels, and the host
   path's 512 features at 12 iterations a level; K2: 150; K3: 150; K4: 8192
   rows) and times both: the wrapper on the host clock, the kernel
   alone on the device with its inputs warm in the L2 cache (beside an empty
   kernel), the least time the card could take for the same work
   (``selfcheck.bound_ms``), and, where that bound is one of bytes above the
   empty kernel's time, the kernel's time with its inputs in device memory.
   Then K1, K2 and K3 against their plain versions at the extra shapes of
   ``selfcheck.extra_problems`` (correctness only).
4. Drives ``DeviceSystem`` (on its default device, the card) — bootstrap plus
   chunks of 8 supersteps — on the
   rendered 1241×376 scene of ``bench.py`` with its overrides, asserts its
   accuracy gates (no failed frame, exact keyframe cadence, scale-aligned
   ATE < 0.10 m, drift < 1.5 %), that every kernel launched during that run
   and that no plain version ran on a CUDA tensor; prints frames/s.
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
   two more chunks are tracked there; the same sequence on the CPU gives the
   same result for every frame.
8. Prints the kernels' JSON line, then last the device JSON line.

Imports nothing of JAX. Exits non-zero on any failure, without a result.
"""

import json
import os
import sys
import time

import numpy as np

SOURCES = {
    "lm_align_level": ("sdvo_tpu_torch/csrc/lm_align.cu", "sdvo_tpu/ops/pallas_lm.py:410"),
    "fa_align_batch": ("sdvo_tpu_torch/csrc/fa_align.cu", "sdvo_tpu/ops/pallas_fa.py:227"),
    "pose_refine": ("sdvo_tpu_torch/csrc/pose_refine.cu", "sdvo_tpu/ops/pallas_pose.py:244"),
    "depth_scores": ("sdvo_tpu_torch/csrc/depth_scores.cu", "sdvo_tpu/ops/pallas_depth.py:57"),
}
K1_HOST_ROW = "lm_align_level[N512]"  # K1 at the host path's shape: a row of its own
SOURCES[K1_HOST_ROW] = SOURCES["lm_align_level"]
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
    for name, args, kw in selfcheck.kernel_problems(device):
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
        bound = selfcheck.bound_ms(name, selfcheck.problem_shapes(name, args), iterations)
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
        row = K1_HOST_ROW if name.startswith(selfcheck.HOST_LM) else base
        r = rows.setdefault(row, {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                                   "bound_ms": 0.0, "t_bytes": 0.0, "t_flops": 0.0,
                                   "device_ms_cold": cold_ms})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        for key, value in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                           ("bound_ms", bound.ms),  # K1: summed over the four levels of one frame
                           ("t_bytes", bound.bytes / selfcheck.PEAK_BYTES_PER_S),
                           ("t_flops", bound.flops / selfcheck.PEAK_F32_FLOPS)):
            r[key] += value
    for r in rows.values():
        r["bound_by"] = "bytes" if r.pop("t_bytes") >= r.pop("t_flops") else "operations"
    check_extra_shapes(device, failures)
    return rows


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


def kernel_modules():
    from sdvo_tpu_torch.ops import depth_scores, fa_align, lm_align, pose_refine

    return {"lm_align_level": lm_align, "fa_align_batch": fa_align, "pose_refine": pose_refine,
            "depth_scores": depth_scores}


class LaunchCount:
    """Sets every kernel's launch count to 0 on entry; on exit holds the
    launches of the block and how often a plain version ran on a CUDA tensor
    in it."""

    def __enter__(self):
        self.mods = kernel_modules()
        for m in self.mods.values():
            m.launches = 0
        self._plain = {k: m.plain_cuda_calls for k, m in self.mods.items()}
        return self

    def __exit__(self, *exc):
        self.launches = {k: m.launches for k, m in self.mods.items()}
        self.plain_on_cuda = {k: m.plain_cuda_calls - self._plain[k] for k, m in self.mods.items()}


def bench_config():
    """bench.py's overrides of the default (KITTI-sized) configuration."""
    from sdvo_tpu_torch.config import load_config

    return load_config(overrides={
        "initialization": {"disparity_threshold": 3, "threshold_gradient_magnitude": 20},
    })


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


def _gate_tracking(name, metrics, trajectory, T_true):
    """bench.py's gates on the frames after the bootstrap: none failed, a
    keyframe every ``PER``-th frame, scale-aligned ATE < 0.10 m, drift < 1.5 %."""
    steady = metrics[2:]
    failed = [m["frame"] for m in steady if m["result"] == "FAILED"]
    _require(not failed, f"{name}: tracking failed on frames {failed}")
    n_kf = sum(m["result"] == "KEYFRAME" for m in steady)
    _require(n_kf == len(steady) // PER, f"{name}: keyframe cadence broken: {n_kf} of {len(steady)}")
    ate, path, drift = accuracy(trajectory, T_true)
    _require(ate < 0.10 and drift < 0.015, f"{name}: accuracy gate failed: ATE {ate}, drift {drift}")
    return ate, path, drift


def run_main_path(card: str, frames, T_true):
    import torch

    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    chunk = SUPERSTEPS_PER_CHUNK * PER
    n_frames = 2 + N_CHUNKS * chunk
    ds = DeviceSystem(bench_config(), supersteps_per_chunk=SUPERSTEPS_PER_CHUNK)  # the card by default
    _require(ds.device.type == "cuda", f"DeviceSystem chose {ds.device}, not the card")

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
    ate, path, drift = _gate_tracking("main path", ds.metrics, ds.trajectory, T_true)
    print(f"main path: {n_frames} frames, bootstrap {t_boot:.2f} s, chunk seconds "
          f"{[round(s, 4) for s in chunk_s]}, ATE {ate:.4f} m over {path:.2f} m "
          f"({100 * drift:.3f} % drift; with the first kernels of K1 and K3 it was 0.0016 m, "
          f"0.058 %), launches {launches}", flush=True)
    for k, n in launches.items():
        _require(n > 0, f"kernel {k} never launched on the main path")
    _require(not any(counts.plain_on_cuda.values()),
             f"plain versions ran on CUDA tensors: {counts.plain_on_cuda}")
    _require(ds.n_relocalizations == 0, "the main path fell back to the host")
    timed = chunk_s[1:]
    fps = len(timed) * chunk / sum(timed)
    print(f"frames/s {fps:.2f} ({card}; DeviceSystem steady state, {len(timed)} chunks of "
          f"{chunk} frames after one warm-up chunk)", flush=True)
    return launches, n_frames - 2


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
    like right after the failed chunk, and the frame on which ``_pack`` put
    the state back on the device."""
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    ds = DeviceSystem(bench_config(), supersteps_per_chunk=REC_SUPERSTEPS, device=device)
    after_failure, repacked = None, None
    for i, im in enumerate(seq):
        on_host = ds.state is None
        ds.add_image(im.astype(np.float32), float(i))
        if i == REC_BLACK[-1]:
            after_failure = (ds.n_relocalizations, ds.state is None, ds.host.status.name)
        if i > REC_BLACK[-1] and on_host and ds.state is not None and repacked is None:
            repacked = i
    ds.finish()
    return ds, after_failure, repacked


def run_recovery(card: str, frames):
    """Failure and recovery: the card against the CPU, frame for frame."""
    seq = [np.zeros_like(f) if i in REC_BLACK else f for i, f in enumerate(frames[:REC_FRAMES])]
    t0 = time.perf_counter()
    with LaunchCount() as counts:
        ds, after_failure, repacked = _drive_recovery(seq, None)  # the card by default
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
    t0 = time.perf_counter()
    twin, _, twin_repacked = _drive_recovery(seq, "cpu")
    twin_results = [m["result"] for m in twin.metrics]
    print(f"recovery on the CPU (plain versions): back on the device path after frame "
          f"{twin_repacked}, results {''.join(r[0] for r in twin_results)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    _require(twin_results == results and twin_repacked == repacked,
             "the port on the card and the port on the CPU disagree on a frame's result")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequence
    from sdvo_tpu_torch.ops import build, selfcheck

    device = torch.device("cuda:0")
    card = selfcheck.card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s ({build.LIB_PATH})", flush=True)

    failures = []
    rows = check_kernels(device, failures)
    frames, T_true = render_bench_sequence(np.random.default_rng(0),
                                           2 + N_CHUNKS * SUPERSTEPS_PER_CHUNK * PER)
    launches, steady_frames = run_main_path(card, frames, T_true)
    launches_host, host_frames = run_host_path(card, frames, T_true)
    run_recovery(card, frames)
    _require(not failures, "; ".join(failures))

    kernels = []
    for name, r in rows.items():
        src, replaces = SOURCES[name]
        base = name.split("[")[0]
        # K1's row at the host path's shape counts that path's launches
        on_path, n_path = ((launches_host, host_frames) if name == K1_HOST_ROW
                           else (launches, steady_frames))
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": on_path[base], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "device_ms": r["device_ms"], "device_ms_cold": r["device_ms_cold"],
                        "launches_per_frame": on_path[base] / n_path,
                        "launches_host_path": launches_host[base]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
