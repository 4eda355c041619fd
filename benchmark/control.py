#!/usr/bin/env python3
"""The readings the check's limits are set from, on the card, in one
process: for each seed a short window of the cell at its own size, then
every number of ``benchmark/harness/check.py`` for the program against the
reference, and with ``--control 1`` for the control (the reference in
float32 with its matrix products rounded to TF32) in the program's place,
on the same sampled states and frames.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 5 --control 1

Prints one JSON line a seed (``program`` and ``control`` readings, each
sampled frame's own gaps under ``frames_program`` / ``frames_control``) and
appends it to ``--out``. The benchmark's own runs never run it.
"""

import argparse
import gc
import json
import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings_for_seed(cell, seed: int, seconds: float, control: bool, device, cam=None, texture_size=None) -> dict:
    """One seed's window and readings (see the module's docstring)."""
    import torch

    from benchmark import scene as scene_mod
    from benchmark.harness import check, drive

    t0 = time.perf_counter()
    w = drive.run_window(cell, seed, seconds, False, device, cam=cam, texture_size=texture_size)
    out = {"seed": seed, "setup_s": w.t0 - t0, "window_s": w.t_end - w.t0, "frames": w.frames,
           "failed": sum(1 for k, (a, b) in enumerate(w.window_frames) for j in range(a, b)
                         if w.trajectories[k][j] is None)}
    cmp = check.Compared(w, cell.traffic, seed)
    del w
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    cam = cam or scene_mod.camera(cell.config["camera"])
    ref = check.Reference(cell.config["settings"], cam, device, package=cell.reference)
    t = time.perf_counter()
    outs = [ref.follow(s[1], s[4]) for s in cmp.steps]
    starts = [ref.repack(snap) for _, _, snap in cmp.starts]
    out["reference_s"] = time.perf_counter() - t
    out["program"] = check.readings(cmp, ref, outs, starts)
    out["frames_program"] = [check.per_frame(s[5], r) for s, r in zip(cmp.steps, outs)]
    if control:
        ctrl = check.Reference(cell.config["settings"], cam, device, tf32=True, package=cell.reference)
        t = time.perf_counter()
        couts = [ctrl.follow(s[1], s[4]) for s in cmp.steps]
        cstarts = [ctrl.repack(snap) for _, _, snap in cmp.starts]
        out["control_s"] = time.perf_counter() - t
        stand_in = types.SimpleNamespace(steps=[s[:5] + (c,) for s, c in zip(cmp.steps, couts)],
                                         starts=[(k, c, snap) for (k, _, snap), c in zip(cmp.starts, cstarts)])
        out["control"] = check.readings(stand_in, ref, outs, starts)
        out["frames_control"] = [check.per_frame(c, r) for c, r in zip(couts, outs)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    import torch

    from benchmark.harness import spec

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.Cell(spec.benchmark(ROOT), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": cell.name, **readings_for_seed(cell, seed, args.seconds, bool(args.control),
                                                                      "cuda")})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
