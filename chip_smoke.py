#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sdvo_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Requires a CUDA card and prints its name and power limit.
2. Builds the hand-written kernels from ``sdvo_tpu_torch/csrc`` (nvcc, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K1: 256 features at all four levels; K2: 150; K3: 150;
   K4: 8192 rows) and times both.
4. Drives ``DeviceSystem`` — bootstrap plus chunks of 8 supersteps — on the
   rendered 1241×376 scene of ``bench.py`` with its overrides, asserts its
   accuracy gates (no failed frame, exact keyframe cadence, scale-aligned
   ATE < 0.10 m, drift < 1.5 %), that every kernel launched during that run
   and that no plain version ran on a CUDA tensor; prints frames/s.
5. Prints the kernels' JSON line, then last the device JSON line.

Imports nothing of JAX. Exits non-zero on any failure, without a result.
"""

import json
import os
import subprocess
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


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check_kernels(device, failures):
    from sdvo_tpu_torch.ops import selfcheck

    rows = {}
    for name, kernel, plain in selfcheck.kernel_cases(device):
        base = name.split("[")[0]
        got, want = kernel(), plain()
        err, ok = selfcheck.agrees(name, got, want)
        ms = selfcheck.median_ms(kernel)
        plain_ms = selfcheck.median_ms(plain)
        detail = ""
        if base == "fa_align_batch":
            uv_d = (got[0] - want[0]).abs().max(1).values
            flipped = int((uv_d > selfcheck.TOLERANCE[base]).sum())
            detail = (f" ({flipped} of {uv_d.numel()} features one LM step apart, at most "
                      f"{selfcheck.FA_STEP_PX} px and {100 * selfcheck.FA_FLIP_SHARE:g} % allowed)")
        print(f"kernel {name}: max_abs_err {err:.3e} (tolerance {selfcheck.TOLERANCE[base]:g}"
              f"{detail}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        if not ok:
            failures.append(f"{name} disagrees with its plain version: {err}")
        r = rows.setdefault(base, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms  # K1: summed over the four levels of one frame
        r["plain_ms"] += plain_ms
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
    ds = DeviceSystem(config, supersteps_per_chunk=SUPERSTEPS_PER_CHUNK, device=device)

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
          f"({100 * drift:.3f} % drift), launches {launches}", flush=True)
    _require(ate < 0.10 and drift < 0.015, f"accuracy gate failed: ATE {ate}, drift {drift}")
    for k, n in launches.items():
        _require(n > 0, f"kernel {k} never launched on the main path")
    _require(not any(plain_on_cuda.values()), f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    timed = chunk_s[1:]
    fps = len(timed) * chunk / sum(timed)
    print(f"frames/s {fps:.2f} ({card}; DeviceSystem steady state, {len(timed)} chunks of "
          f"{chunk} frames after one warm-up chunk)", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from sdvo_tpu_torch.ops import build

    device = torch.device("cuda:0")
    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s ({build.LIB_PATH})", flush=True)

    failures = []
    rows = check_kernels(device, failures)
    launches = run_main_path(device, card)
    _require(not failures, "; ".join(failures))

    kernels = []
    for name, r in rows.items():
        src, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
