#!/usr/bin/env python3
"""Where does the long run on the card part from the port on the CPU?

Run from the repository root on a machine with a CUDA card: ``python3
tools/trace_long_drift.py [--out build/trace_long_drift.json] [--perturb 2]
[--frame F]`` (~9 min on an H100 and its host). Imports ``sdvo_tpu_torch``
and ``chip_smoke``, never JAX.

1. ``chip_smoke.drive_long`` (the JAX package's long run: 300 frames at
   320×240, black 150-158, chunks of 4 supersteps) on the card, as
   ``DeviceSystem`` ships, and on the CPU (the kernels' plain versions) over
   the same frames: each run's drift before the blackout and over the run,
   and the first frame whose camera centres lie further apart than float32
   rounding, ``CENTRE_TOL`` (16 float32 ulps at 1 m: the centres are of
   order 1 m, each a chain of some tens of float32 operations).
2. The card's state just before that frame: the card's run again with
   chunks of one superstep as the eager loop up to that frame's superstep
   (which must give the step-1 run's poses bit for bit), then the frames
   before it one by one (``DeviceVO._frame_step``).
3. That frame's steps on the card, each stage's inputs and outputs kept:
   the pyramid, K1 at each level, the reprojection (and K2 in it), K3, the
   filter update (and K4 in it) and, on a keyframe, the keyframe step. Each
   stage then runs on the CPU on the card's own inputs (copied), and the
   tool prints each stage's largest difference (the output it is in and
   the two values) beside its known gap, and the first stage beyond it. A
   stage's known gap is its kernel's stated gap to the plain version
   (``KERNELS``, ``ops.selfcheck``) or rounding: no more than
   ``ROUNDING_FACTOR`` times the stage's own spread on the CPU when its
   float inputs move by one float32 ulp. The same frame from the same state
   on the CPU as a whole gives the frame's own gap. ``--frame F`` traces
   frame F instead.
4. ``--perturb P``: P more runs on the card and P on the CPU with every
   frame moved by seeded Gaussian noise of 1e-4 grey levels, and their
   drift: how far the scene itself carries input changes the size of
   rounding, on each device.

Writes every number to ``--out`` as JSON, each traced stage's inputs and the
card's outputs beside it (``*_frame.pt``, CPU tensors), and prints a line a
step.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CENTRE_TOL = 16 * 2.0 ** -23  # m: 16 float32 ulps at 1 m
# the kernels' stated gaps between the card and their plain versions on the
# same inputs (``ops.selfcheck``: K1, K3 and K4 within TOLERANCE of every
# output; K2 by ``selfcheck.agrees``, a few features one LM step apart at a
# stall test's edge); K1 may also take one iteration more or less there
KERNELS = {"K1": "lm_align_level", "K2": "fa_align_batch", "K3": "pose_refine", "K4": "depth_scores"}
# every stage's gap against its own spread under rounding: the same stage on
# the CPU with its float inputs moved by one float32 ulp (ULP_SEEDS random
# patterns); a gap within ROUNDING_FACTOR times that spread is rounding
ULP_SEEDS, ROUNDING_FACTOR = 3, 10.0


def _tree_to(tree, device):
    import torch

    from sdvo_tpu_torch.pipeline.cuda_graph import flatten, unflatten

    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    leaves, spec = flatten(tree)
    return unflatten(spec, [x.detach().to(device).clone() if isinstance(x, torch.Tensor) else x for x in leaves])


def _ulp_moved(tree, seed: int):
    """``tree`` with every float tensor moved by one float32 ulp at random
    entries (up, down or not at all)."""
    import torch

    from sdvo_tpu_torch.pipeline.cuda_graph import flatten, unflatten

    if isinstance(tree, dict):
        return {k: _ulp_moved(v, seed + i) for i, (k, v) in enumerate(tree.items())}
    g = torch.Generator().manual_seed(seed)
    leaves, spec = flatten(tree)
    return unflatten(spec, [x * (1.0 + torch.randint(-1, 2, x.shape, generator=g).to(x.dtype) * 2.0 ** -24)
                            if isinstance(x, torch.Tensor) and x.dtype.is_floating_point else x
                            for x in leaves])


def _named(tree, path="out"):
    import torch

    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _named(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _named(x, f"{path}[{i}]")


def gap(a_tree, b_tree) -> dict:
    """The largest float difference of two output trees (absolute, and
    relative to max(1, the leaf's largest |value|)), the leaf it is in with
    the two values there, and the integer and mask entries that differ."""
    import torch

    out = {"abs": 0.0, "rel": 0.0, "leaf": None, "values": None, "int_mask_apart": 0, "int_mask_leaves": []}
    for (name, x), (_, y) in zip(_named(a_tree), _named(b_tree)):
        x, y = x.detach().cpu(), y.detach().cpu()
        if not x.dtype.is_floating_point:
            n = int((x != y).sum())
            if n:
                out["int_mask_apart"] += n
                out["int_mask_leaves"].append(name)
            continue
        xd, yd = x.double(), y.double()
        fin = torch.isfinite(xd) & torch.isfinite(yd)
        n = int((torch.isfinite(xd) != torch.isfinite(yd)).sum())
        if n:
            out["int_mask_apart"] += n
            out["int_mask_leaves"].append(name + " (finite)")
        if not fin.any():
            continue
        d = torch.where(fin, (xd - yd).abs(), torch.zeros_like(xd))
        rel = d.max().item() / max(1.0, xd[fin].abs().max().item())
        if rel > out["rel"]:
            k = int(d.reshape(-1).argmax())
            out.update(abs=d.max().item(), rel=rel, leaf=name,
                       values=[xd.reshape(-1)[k].item(), yd.reshape(-1)[k].item()])
    return out


def judge(stage: str, card_out, cpu_out, spread: dict) -> dict:
    """The card against the CPU on one stage, beside the kernel's stated gap
    (K1-K4) and the stage's spread under one-ulp input moves."""
    from sdvo_tpu_torch.ops import selfcheck

    g = gap(card_out, cpu_out)
    rounding = g["rel"] <= ROUNDING_FACTOR * spread["rel"] and (
        g["int_mask_apart"] == 0 or spread["int_mask_apart"] > 0)
    kernel = None
    if stage in KERNELS:
        name = KERNELS[stage]
        if stage == "K2":
            kernel = selfcheck.agrees(name, tuple(card_out), tuple(cpu_out))[1]
        else:
            iters_only = stage in ("K1", "K3") and g["int_mask_leaves"] == ["out[2]"]
            kernel = g["abs"] <= selfcheck.TOLERANCE[name] and (
                g["int_mask_apart"] == 0 or (iters_only and abs(int(card_out[2]) - int(cpu_out[2])) == 1))
    return {"stage": stage, "gap": g, "ulp_spread": spread, "within_kernel_tolerance": kernel,
            "within_rounding": bool(rounding), "within_known_gap": bool(rounding or kernel)}


class Recorder:
    """Wraps each stage's function where the frame step looks it up; while
    ``on``, keeps (stage, function, inputs on the CPU, outputs on the CPU)
    of every call."""

    def __init__(self, vo):
        import sdvo_tpu_torch.align.feature_alignment as fa_mod
        import sdvo_tpu_torch.align.image_alignment as ia_mod
        import sdvo_tpu_torch.depth.epipolar as ep_mod
        import sdvo_tpu_torch.pipeline.device_system as ds_mod

        self.on, self.calls, self._patched = False, [], []
        for mod, name, stage in ((ds_mod, "build_pyramid", "pyramid"), (ia_mod, "lm_align_level", "K1"),
                                 (ds_mod, "reproject_device", "reprojection"), (fa_mod, "fa_align_batch", "K2"),
                                 (ds_mod, "pose_refine", "K3"), (ds_mod, "update_filters", "filter update"),
                                 (ep_mod, "depth_scores", "K4")):
            fn = getattr(mod, name)
            self._patched.append((mod, name, fn))
            setattr(mod, name, self._wrap(stage, fn))
        self.vo, self._kf = vo, vo._keyframe_step
        vo._keyframe_step = self._wrap("keyframe step", self._kf)

    def _wrap(self, stage, fn):
        def run(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            cpu_in = (_tree_to(args, "cpu"), _tree_to(kwargs, "cpu"))
            out = fn(*args, **kwargs)
            self.calls.append((stage, fn, cpu_in, _tree_to(out, "cpu")))
            return out
        return run

    def restore(self):
        for mod, name, fn in self._patched:
            setattr(mod, name, fn)
        self.vo._keyframe_step = self._kf


def _drift_line(gates) -> dict:
    return {k: gates[k] for k in ("drift_pre", "drift", "keyframes", "relocalizations", "failed")}


def trace_frame(first: int, frames, device, report, out_path: str):
    """Steps 2 and 3 for frame ``first``: the card's state before it, then
    its stages on the card and again on the CPU on the card's inputs."""
    import torch

    import chip_smoke
    from sdvo_tpu_torch.convert import to_numpy, vo_state_from_numpy
    from sdvo_tpu_torch.dataio.synthetic import LONG_CAMERA
    from sdvo_tpu_torch.device import deterministic_on
    from sdvo_tpu_torch.geometry.camera import PinholeCamera
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    def system(dev, supersteps):
        return DeviceSystem(chip_smoke.long_config(), camera=PinholeCamera.create(**LONG_CAMERA), device=dev,
                            **dict(chip_smoke.LONG_KW, supersteps_per_chunk=supersteps))

    ds = system(device, 1)
    ds.vo.run_chunk = ds.vo.run_chunk_eager
    for i in range(first):
        ds.add_image(frames[i], float(i))
    if ds.state is None:
        print(f"frame {first} is on the host path (relocalization): no device state to trace", flush=True)
        return
    # the frames after the last superstep boundary wait in the buffer
    start = first - len(ds._buffer)
    state, vo = ds.state, ds.vo
    images = [torch.from_numpy(f).to(ds.device) for f in frames[:first + 1]]
    with deterministic_on(ds.device):
        for j in range(start, first):
            state, _ = vo._frame_step(state, images[j], is_kf=False)
    same = all((a is None and b is None) or np.array_equal(a, b)
               for a, b in zip(ds.trajectory[:start], report["_card_trajectory"][:start]))
    is_kf = first - start == chip_smoke.PER - 1
    report["state_before"] = {"frames_through_chunks": start, "frames_one_by_one": first - start,
                              "same_bits_as_the_run": bool(same), "frame_is_keyframe": is_kf}
    print(f"state before frame {first}: {start} frames through chunks of one superstep (the run's bits: "
          f"{same}), {first - start} stepped one by one; the frame is {'a' if is_kf else 'no'} keyframe",
          flush=True)

    cpu_vo = system("cpu", 1).vo
    rec = Recorder(vo)
    rec.on = True
    try:
        with deterministic_on(ds.device):
            _, card_frame = vo._frame_step(state, images[first], is_kf=is_kf)
    finally:
        rec.on = False
        rec.restore()
    stages = []
    for stage, fn, (args, kwargs), card_out in rec.calls:
        fn = cpu_vo._keyframe_step if stage == "keyframe step" else fn
        cpu_out = fn(*args, **kwargs)
        spread = [gap(fn(*_ulp_moved(args, 10 * k), **_ulp_moved(kwargs, 10 * k + 5)), cpu_out)
                  for k in range(ULP_SEEDS)]
        stages.append(judge(stage, card_out, cpu_out, {
            "rel": max(x["rel"] for x in spread), "int_mask_apart": max(x["int_mask_apart"] for x in spread)}))
    # each stage's inputs and the card's outputs, on the CPU, for a look without the card
    torch.save([(stage, inputs, card_out) for stage, _, inputs, card_out in rec.calls],
               os.path.splitext(out_path)[0] + "_frame.pt")
    _, cpu_frame = cpu_vo._frame_step(vo_state_from_numpy(to_numpy(state), device="cpu"), images[first].cpu(),
                                      is_kf=is_kf)
    report["stages"] = stages
    report["whole_frame"] = gap(card_frame, cpu_frame)
    report["first_stage_beyond_known_gap"] = next((s["stage"] for s in stages if not s["within_known_gap"]), None)
    for s in stages:
        g = s["gap"]
        print(f"  {s['stage']}: largest gap {g['abs']:.3e} ({g['rel']:.3e} relative) in {g['leaf']} "
              f"{g['values']}, integer/mask entries apart {g['int_mask_apart']} {g['int_mask_leaves']}; "
              f"its spread under one-ulp input moves {s['ulp_spread']['rel']:.3e} relative, "
              f"{s['ulp_spread']['int_mask_apart']} entries apart; within the kernel's tolerance "
              f"{s['within_kernel_tolerance']}, within rounding {s['within_rounding']}", flush=True)
    print(f"frame {first} from the same state, card against CPU as a whole: {json.dumps(report['whole_frame'])}; "
          f"first stage beyond its known gap: {report['first_stage_beyond_known_gap']}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "trace_long_drift.json"))
    ap.add_argument("--perturb", type=int, default=2, help="card runs with frames moved by 1e-4 grey levels")
    ap.add_argument("--device", default="cuda", help="the device traced against the CPU (cpu: a dry run)")
    ap.add_argument("--frame", type=int, default=None, help="trace this frame, not the first that parts the runs")
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("trace_long_drift: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from sdvo_tpu_torch.dataio.synthetic import render_long_sequence
    from sdvo_tpu_torch.ops import selfcheck

    card = selfcheck.card_line() if args.device == "cuda" else "cpu"
    report = {"card": card, "centre_tol_m": CENTRE_TOL}
    print(card, flush=True)
    frames, T_true = render_long_sequence(chip_smoke.LONG_FRAMES, chip_smoke.LONG_BLACK)

    # 1. the two runs and the first frame that parts them
    t0 = time.perf_counter()
    runs = {}
    for name, dev in (("card", args.device), ("cpu", "cpu")):
        runs[name] = chip_smoke.drive_long(frames, device=dev)[0]
        report[f"{name}_run"] = _drift_line(chip_smoke.long_gates(runs[name], T_true))
        print(f"{name}: {json.dumps(report[f'{name}_run'])}", flush=True)
    centre = lambda T: -T[:3, :3].T @ T[:3, 3]  # noqa: E731
    gaps = [None if a is None or b is None else float(np.linalg.norm(centre(a) - centre(b)))
            for a, b in zip(runs["card"].trajectory, runs["cpu"].trajectory)]
    first = next((i for i, g in enumerate(gaps) if g is not None and g > CENTRE_TOL), None)
    report["first_result_differs"] = next((i for i, (a, b) in enumerate(zip(runs["card"].metrics, runs["cpu"].metrics))
                                           if a["result"] != b["result"]), None)
    report["first_frame_apart"] = first
    report["first_frame_over_m"] = {f"{t:g}": next((i for i, g in enumerate(gaps) if g is not None and g > t), None)
                                    for t in (CENTRE_TOL, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)}
    report["centre_gap_m"] = gaps
    print(f"first frame whose centres lie more than {CENTRE_TOL:.3g} m apart: {first}; the first frame over each "
          f"distance (m): {report['first_frame_over_m']}; the first frame whose result differs: "
          f"{report['first_result_differs']} ({time.perf_counter() - t0:.1f} s)", flush=True)
    report["_card_trajectory"] = runs["card"].trajectory
    traced = first if args.frame is None else args.frame
    report["traced_frame"] = traced
    if traced is not None and traced >= 2:
        trace_frame(traced, frames, args.device, report, args.out)
    elif traced is not None:
        print(f"frame {traced} is the host bootstrap's", flush=True)
    del report["_card_trajectory"]

    # 4. the scene's own spread under input changes the size of rounding
    for name, dev in (("card", args.device), ("cpu", "cpu")):
        spread = []
        for k in range(args.perturb):
            noise = np.random.default_rng(100 + k)
            moved = [f + noise.normal(0.0, 1e-4, f.shape).astype(np.float32) if f.any() else f for f in frames]
            spread.append(_drift_line(chip_smoke.long_gates(chip_smoke.drive_long(moved, device=dev)[0], T_true)))
            print(f"{name} run with frames moved by 1e-4 grey levels (seed {100 + k}): {json.dumps(spread[-1])}",
                  flush=True)
        report[f"perturbed_{name}_runs"] = spread
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"trace_long_drift: {json.dumps({k: v for k, v in report.items() if k != 'centre_gap_m'})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
