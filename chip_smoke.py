#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sdvo_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Requires a CUDA card and prints its name and power limit.
2. Builds the hand-written kernels from ``sdvo_tpu_torch/csrc`` (nvcc, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K1: 256 features at all four levels; K2: 150; K3: 150;
   K4: 8192 rows) and times both: the wrapper on the host clock, the kernel
   alone on the device with its inputs warm in the L2 cache (beside an empty
   kernel), the least time the card could take for the same work
   (``selfcheck.bound_ms``), and, where that bound is one of bytes above the
   empty kernel's time, the kernel's time with its inputs in device memory.
4. Drives ``DeviceSystem`` (on its default device, the card) — bootstrap plus
   chunks of 8 supersteps — on the
   rendered 1241×376 scene of ``bench.py`` with its overrides, asserts its
   accuracy gates (no failed frame, exact keyframe cadence, scale-aligned
   ATE < 0.10 m, drift < 1.5 %), that every kernel launched during that run
   and that no plain version ran on a CUDA tensor; prints frames/s.
5. Prints the kernels' JSON line, then last the device JSON line.

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
        r = rows.setdefault(base, {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
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
    return rows


def run_main_path(device, card: str):
    import torch

    from sdvo_tpu_torch.config import load_config
    from sdvo_tpu_torch.dataio.evaluate import ate_rmse
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequence
    from sdvo_tpu_torch.ops import depth_scores, fa_align, lm_align, pose_refine
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    mods = {"lm_align_level": lm_align, "fa_align_batch": fa_align, "pose_refine": pose_refine,
            "depth_scores": depth_scores}
    chunk = SUPERSTEPS_PER_CHUNK * PER
    frames, T_true = render_bench_sequence(np.random.default_rng(0), 2 + N_CHUNKS * chunk)
    config = load_config(overrides={
        "initialization": {"disparity_threshold": 3, "threshold_gradient_magnitude": 20},
    })
    ds = DeviceSystem(config, supersteps_per_chunk=SUPERSTEPS_PER_CHUNK)  # the card by default
    _require(ds.device.type == "cuda", f"DeviceSystem chose {ds.device}, not the card")

    for m in mods.values():
        m.launches = 0
    plain_before = {k: m.plain_cuda_calls for k, m in mods.items()}
    t_start = time.perf_counter()
    ds.add_image(frames[0].astype(np.float32), 0.0)
    ds.add_image(frames[1].astype(np.float32), 1.0)
    _require(ds.bootstrapped, "two-view bootstrap failed")
    t_boot = time.perf_counter() - t_start
    chunk_s = []
    for c in range(N_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(2 + c * chunk, 2 + (c + 1) * chunk):
            ds.add_image(frames[i].astype(np.float32), float(i))
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    ds.finish()
    launches = {k: m.launches for k, m in mods.items()}
    plain_on_cuda = {k: m.plain_cuda_calls - plain_before[k] for k, m in mods.items()}

    n_frames = len(frames)
    _require(len(ds.trajectory) == n_frames, f"{len(ds.trajectory)} poses for {n_frames} frames")
    steady = ds.metrics[2:]
    failed = [m["frame"] for m in steady if m["result"] == "FAILED"]
    _require(not failed, f"tracking failed on frames {failed}")
    n_kf = sum(m["result"] == "KEYFRAME" for m in steady)
    _require(n_kf == len(steady) // PER, f"keyframe cadence broken: {n_kf} of {len(steady)}")
    est = np.asarray([-T[:3, :3].T @ T[:3, 3] for T in ds.trajectory[2:]])
    gt = np.asarray([-T[:3, :3].T @ T[:3, 3] for T in T_true[2:]])
    _require(bool(np.all(np.isfinite(est))), "non-finite poses")
    ate = ate_rmse(est, gt, with_scale=True)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    drift = ate / max(path, 1e-9)
    print(f"main path: {n_frames} frames, bootstrap {t_boot:.2f} s, chunk seconds "
          f"{[round(s, 4) for s in chunk_s]}, ATE {ate:.4f} m over {path:.2f} m "
          f"({100 * drift:.3f} % drift; with the first kernels of K1 and K3 it was 0.0016 m, "
          f"0.058 %), launches {launches}", flush=True)
    _require(ate < 0.10 and drift < 0.015, f"accuracy gate failed: ATE {ate}, drift {drift}")
    for k, n in launches.items():
        _require(n > 0, f"kernel {k} never launched on the main path")
    _require(not any(plain_on_cuda.values()), f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    timed = chunk_s[1:]
    fps = len(timed) * chunk / sum(timed)
    print(f"frames/s {fps:.2f} ({card}; DeviceSystem steady state, {len(timed)} chunks of "
          f"{chunk} frames after one warm-up chunk)", flush=True)
    return launches, len(steady)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
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
    launches, steady_frames = run_main_path(device, card)
    _require(not failures, "; ".join(failures))

    kernels = []
    for name, r in rows.items():
        src, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "device_ms": r["device_ms"], "device_ms_cold": r["device_ms_cold"],
                        "launches_per_frame": launches[name] / steady_frames})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
