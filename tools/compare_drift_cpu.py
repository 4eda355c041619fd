#!/usr/bin/env python3
"""Does the JAX package drift where the port does? bench.py's scene through
both packages' ``DeviceSystem`` on the CPU.

Run from the repository root: ``python3 tools/compare_drift_cpu.py [--seeds
0,1] [--frames 74] [--max-rss-gb 24] [--budget-s 900] [--x64] [--own-draws]``. For each
texture seed of bench.py's scene (the camera path is the same for every
seed) it renders 2 + 72 frames (``chip_smoke.py``'s main path: a bootstrap
and three chunks of 8 supersteps), then runs

- the JAX package's ``DeviceSystem`` with its CPU default (the XLA path, no
  Pallas kernel), configured as bench.py configures it (x64 off, unless
  ``--x64``), and
- the port's ``DeviceSystem`` with ``device="cpu"`` (the kernels' plain
  versions), given the JAX run's RANSAC draws so that both bootstrap from
  the same samples (``--own-draws``: its own, those it draws on the card),

and prints a JSON line a run (failed frames, keyframes, scale-aligned ATE,
drift, ``chip_smoke``'s gates) and one a seed comparing the two frame by
frame: the first frame whose result differs, the first frame whose camera
centres lie more than 1 % of the JAX run's path apart (both in the units of
the estimates), and the largest distance.

Each package's run is time-boxed (``--budget-s``, checked at every frame)
and the process's resident memory is capped (``--max-rss-gb``, polled every
second): a run over either prints how far it got and the tool goes on with
the next. Not a tier-1 test: a seed takes minutes.

``--long`` runs the JAX package's long run instead (``tests/
test_long_sequence.py``: its 300 frames at 320×240 from its own
``_render_long``, black 150-158, its configuration, x64 on as its tests
run it) through both packages, the port given the same frames and the JAX
run's RANSAC draws, and prints each run's drift (scale-aligned ATE over the
path length) before the blackout and over the whole run, as that test
computes them, then the frame-by-frame comparison.
"""

import argparse
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def _rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    return 0.0


def _watch_memory(limit_gb: float):
    """Ends the process (exit code 3) when its resident memory passes the
    limit, saying so."""
    def run():
        while True:
            rss = _rss_gb()
            if rss > limit_gb:
                print(json.dumps({"stopped": "memory", "rss_gb": rss, "limit_gb": limit_gb}), flush=True)
                os._exit(3)
            time.sleep(1.0)
    threading.Thread(target=run, daemon=True).start()


def _drive(ds, frames, budget_s: float):
    """Feeds the frames; returns (seconds, frames fed, whether all were)."""
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        if time.perf_counter() - t0 > budget_s:
            return time.perf_counter() - t0, i, False
        ds.add_image(f, float(i))
    ds.finish()
    return time.perf_counter() - t0, len(frames), True


def _centres(trajectory):
    return np.asarray([np.full(3, np.nan) if T is None else -np.asarray(T)[:3, :3].T @ np.asarray(T)[:3, 3]
                       for T in trajectory])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--frames", type=int, default=74)
    ap.add_argument("--max-rss-gb", type=float, default=24.0)
    ap.add_argument("--budget-s", type=float, default=900.0, help="seconds a package's run may take")
    ap.add_argument("--x64", action="store_true", help="the JAX side with float64 on, as its tests run")
    ap.add_argument("--own-draws", action="store_true", help="the port with its own RANSAC draws")
    ap.add_argument("--long", action="store_true", help="the long run of tests/test_long_sequence.py")
    args = ap.parse_args()
    if args.long:
        args.x64 = True
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    _watch_memory(args.max_rss_gb)

    import jax.numpy as jnp
    import torch

    import chip_smoke
    from sdvo_tpu.config import load_config as j_load_config
    from sdvo_tpu.pipeline.device_system import DeviceSystem as JDeviceSystem
    from sdvo_tpu.pipeline.system import System as JSystem
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequence
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    overrides = {"initialization": {"disparity_threshold": 3, "threshold_gradient_magnitude": 20}}
    t_config = chip_smoke.bench_config()
    j_kw = t_kw = dict(supersteps_per_chunk=chip_smoke.SUPERSTEPS_PER_CHUNK)
    if args.long:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import test_long_sequence
        from sdvo_tpu.geometry.camera import PinholeCamera as JCamera
        from sdvo_tpu_torch.dataio.synthetic import LONG_CAMERA
        from sdvo_tpu_torch.geometry.camera import PinholeCamera

        overrides, t_config = chip_smoke.LONG_OVERRIDES, chip_smoke.long_config()
        j_kw = dict(chip_smoke.LONG_KW, camera=JCamera.create(**LONG_CAMERA, dtype=jnp.float64))
        t_kw = dict(chip_smoke.LONG_KW, camera=PinholeCamera.create(**LONG_CAMERA))
        args.seeds = "11"  # the test's texture
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        if args.long:
            _, frames, T_true = test_long_sequence._render_long(np.random.default_rng(seed))
        else:
            frames, T_true = render_bench_sequence(np.random.default_rng(seed), args.frames)
        frames = [np.asarray(f, np.float32) for f in frames]
        print(json.dumps({"seed": seed, "rendered_s": time.perf_counter() - t0}), flush=True)
        runs = {}
        for pkg in ("jax", "port"):
            if pkg == "jax":
                ds = JDeviceSystem(j_load_config(overrides=overrides), **j_kw)
            elif args.own_draws:
                ds = DeviceSystem(t_config, device="cpu", **t_kw)
            else:
                # the JAX System's RANSAC draws for its bootstrap (seed 0: the
                # first split of PRNGKey(0)), over the port's frame-0 features
                probe = JSystem(j_load_config(overrides=overrides), camera=j_kw.get("camera"))
                probe.add_image(frames[0], 0.0)
                _, sub = jax.random.split(jax.random.PRNGKey(0))
                n_feat = len(probe.ref_frame.feat_uv)
                hyp = probe.config.initialization.ransac_hypotheses
                uniforms = np.asarray(jax.random.uniform(sub, (hyp, n_feat), dtype=jnp.float64 if args.x64
                                                         else jnp.float32), np.float64)
                ds = DeviceSystem(t_config, device="cpu", ransac_uniforms=uniforms, **t_kw)
            seconds, fed, whole = _drive(ds, frames, args.budget_s)
            line = {"seed": seed, "package": pkg, "seconds": seconds, "frames_fed": fed,
                    "frames_done": len(ds.trajectory), "finished": whole, "x64": args.x64,
                    "port_draws": "own" if args.own_draws else "jax",
                    "rss_gb": _rss_gb()}
            if whole and args.long:
                est, gt, idx = chip_smoke._centres_of(ds.trajectory, T_true)
                pre = idx < chip_smoke.LONG_BLACK.start
                (ate_pre, path_pre), (ate, path) = chip_smoke.drift(est[pre], gt[pre]), chip_smoke.drift(est, gt)
                line.update(failed_frames=[m["frame"] for m in ds.metrics if m["result"] == "FAILED"],
                            relocalizations=ds.n_relocalizations, drift_before_blackout=ate_pre / path_pre,
                            drift=ate / path, ate_m=ate, path_m=path)
            elif whole:
                failed, n_kf, n, ate, path, drift, broken = chip_smoke.tracking_gates(
                    ds.metrics, ds.trajectory, T_true)
                line.update(failed_frames=failed, keyframes=n_kf, frames=n, ate_m=ate, path_m=path,
                            drift=drift, passes=broken is None)
            print(json.dumps(line), flush=True)
            runs[pkg] = ds
        a, b = runs["jax"], runs["port"]
        n = min(len(a.trajectory), len(b.trajectory))
        res_a = [m["result"] for m in a.metrics[:n]]
        res_b = [m["result"] for m in b.metrics[:n]]
        ca, cb = _centres(a.trajectory[:n]), _centres(b.trajectory[:n])
        ok = np.all(np.isfinite(ca), -1)  # monocular scale is free: the JAX run's path is the unit
        path = float(np.sum(np.linalg.norm(np.diff(ca[ok], axis=0), axis=-1)))
        apart = np.linalg.norm(ca - cb, axis=-1)
        first_result = next((i for i in range(n) if res_a[i] != res_b[i]), None)
        first_apart = next((i for i in range(n) if apart[i] > 0.01 * path), None)  # a frame failed in both is not apart
        print(json.dumps({"seed": seed, "compared_frames": n, "first_result_differs": first_result,
                          "first_frame_centres_over_1pct_of_path": first_apart,
                          "max_centre_distance_m": float(np.nanmax(apart)) if n else None,
                          "path_m": path, "centre_distance_m": [float(x) for x in apart]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
