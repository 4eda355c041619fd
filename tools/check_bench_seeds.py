#!/usr/bin/env python3
"""Which texture seeds of bench.py's scene the port's ``DeviceSystem`` tracks
alone, on a CUDA card.

Run from the repository root: ``python3 tools/check_bench_seeds.py [N
[FIRST]] [--seeds S,S,...]``. For each of N texture seeds from FIRST (default
12 from 0), or each seed of ``--seeds`` (the camera path is bench.py's for
every seed), it runs ``DeviceSystem`` with chunks of 8 supersteps over 2 +
3·24 frames, as ``chip_smoke.py``'s main path does, and prints the failed
frames, the keyframe count, the scale-aligned ATE and drift, and whether the
seed passes ``chip_smoke.py``'s gates (``chip_smoke.tracking_gates``). The
multi-sequence phase of ``chip_smoke.py`` takes seeds 0-7, each one that
fails here replaced by the next that passes. Imports nothing of JAX; fails
without a card.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import torch  # noqa: E402

from sdvo_tpu_torch.dataio.synthetic import render_bench_sequence  # noqa: E402
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem  # noqa: E402

N_FRAMES = 2 + chip_smoke.N_CHUNKS * chip_smoke.SUPERSTEPS_PER_CHUNK * chip_smoke.PER


def main() -> int:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=12)
    ap.add_argument("first", nargs="?", type=int, default=0)
    ap.add_argument("--seeds", default=None, help="comma-separated seeds, in place of N and FIRST")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("check_bench_seeds: no CUDA device", file=sys.stderr)
        return 1
    seeds = ([int(x) for x in args.seeds.split(",")] if args.seeds
             else list(range(args.first, args.first + args.n)))
    passing = []
    for seed in seeds:
        frames, T_true = render_bench_sequence(np.random.default_rng(seed), N_FRAMES)
        ds = DeviceSystem(chip_smoke.bench_config(), supersteps_per_chunk=chip_smoke.SUPERSTEPS_PER_CHUNK)
        for i, f in enumerate(frames):
            ds.add_image(f.astype(np.float32), float(i))
        ds.finish()
        failed, n_kf, n, ate, _, drift, broken = chip_smoke.tracking_gates(ds.metrics, ds.trajectory, T_true)
        passing += [seed] if broken is None else []
        print(json.dumps({"seed": seed, "failed_frames": failed, "keyframes": n_kf, "frames": n,
                          "ate_m": ate, "drift": drift, "passes": broken is None,
                          "relocalizations": ds.n_relocalizations}), flush=True)
    print(f"seeds that pass alone: {passing}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
