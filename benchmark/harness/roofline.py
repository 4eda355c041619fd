"""The least time one H100 could take for a launch of each of the port's four
kernels: a frozen copy of ``sdvo_tpu_torch/ops/selfcheck.py``'s ``bound_ms``
and its operation counts, and the record of each launch's shapes.

``bound_ms(name, shapes, iterations)`` is the larger of the bytes the launch
must move (each input read once, each output written once) at 3.35 TB/s and
its float32 operations at 67 TFLOP/s, the published peaks of one H100 SXM at
700 W. Where the work depends on the data and the trace cannot see it, the
count is the least the launch can do, so a share is never overstated:

* K1 (``lm_align_level``) and K2 (``fa_align_batch``) are bound by their
  bytes at any iteration count up to their budget, so their operations are
  counted at the budget the call was given;
* K3 (``pose_refine``) is bound by operations; it is counted at one
  iteration, the least a call makes;
* K4 (``depth_scores``) reads of its windows only the 32-byte sectors its
  bilinear footprints touch: counted as one sector for each of the
  patch + 1 window rows a footprint spans, the least any offset touches.

``LaunchShapes`` records, from outside the program, the shapes of every
launch of a run that is not being captured into a CUDA graph (the capture's
warm-up runs the chunk once on the host's side of the card's stream, and a
replay launches what it captured): it wraps each kernel module's ``_op`` and
restores it in ``close``.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Operations the LM kernels' function needs per residual (float32 adds,
# multiplies and compares, a fused multiply-add as two), as selfcheck counts
# them: robust scale, H/g sums, the histogram stage, a bilinear sample.
_SCALE_FLOPS = 3 + 4 * 5 + 3 + 8
_STAGE_FLOPS = 4 * 16
_FROZEN_FLOPS = 1 + 8
_HG_FLOPS = 6 + 2 * 27 + 6
_BILINEAR_FLOPS = 12
_FA_BISECT_STEPS = 10
_FA_EVAL_FLOPS = _BILINEAR_FLOPS + 2 + 2 + 2 * 2 * _FA_BISECT_STEPS + 3 + 8
_FA_HG_FLOPS = 2 + 2 * 9 + 6
_FA_FINAL_FLOPS = 2 + 2 + 3
_PROJECT_FLOPS = 24
SECTOR = 32

# each kernel's function name in the port's csrc/, as the profiler names its
# launches, and the module whose ``_op`` launches it
KERNELS = {
    "lm_align_level": ("lm_align_level_kernel", "sdvo_tpu_torch.ops.lm_align"),
    "fa_align_batch": ("fa_align_kernel", "sdvo_tpu_torch.ops.fa_align"),
    "pose_refine": ("pose_refine_kernel", "sdvo_tpu_torch.ops.pose_refine"),
    "depth_scores": ("depth_scores_kernel", "sdvo_tpu_torch.ops.depth_scores"),
}


class Bound(NamedTuple):
    ms: float
    by: str  # "bytes" or "operations"
    bytes: int
    flops: int


def bound_ms(name: str, shapes: Dict[str, int], iterations: Optional[int] = None) -> Bound:
    """The least time for one launch of kernel ``name`` at ``shapes`` (``N``,
    ``WH``, ``WW``, ``P2``; K3 ``N`` alone; K4 also ``win_bytes`` and
    ``steps``; ``frozen`` for K1's freeze_sigma)."""
    N = shapes["N"]
    if name == "pose_refine":
        nbytes = 4 * (N * 7 + 12 + 12 + 4)
        per_eval = N * (_PROJECT_FLOPS + 3 * (1 + _SCALE_FLOPS)) + _STAGE_FLOPS
        per_iter = N * 3 * (30 + _HG_FLOPS)
        flops = (iterations + 1) * per_eval + iterations * per_iter
    else:
        WH, WW, P2 = shapes["WH"], shapes["WW"], shapes["P2"]
        if name == "lm_align_level":
            nbytes = 4 * (N * (WH * WW + P2 * 7 + 6) + 12 + 12 + 4)
            frozen = shapes.get("frozen", 0)
            scale = _FROZEN_FLOPS if frozen else _SCALE_FLOPS
            per_eval = (N * (_PROJECT_FLOPS + P2 * (_BILINEAR_FLOPS + 1 + scale))
                        + (0 if frozen else _STAGE_FLOPS))
            flops = (iterations + 1) * per_eval + iterations * N * P2 * _HG_FLOPS
        elif name == "fa_align_batch":
            nbytes = 4 * N * (WH * WW + 3 * P2 + 4 + 3) + 2 * N
            its = iterations or 10
            flops = N * P2 * ((its + 1) * _FA_EVAL_FLOPS + its * _FA_HG_FLOPS + _FA_FINAL_FLOPS)
        elif name == "depth_scores":
            nbytes = shapes["win_bytes"] + 4 * (N // shapes.get("steps", 1)) * P2 + 4 * N * (2 + 2)
            flops = N * P2 * (_BILINEAR_FLOPS + 1 + 2 + 3)
        else:
            raise KeyError(name)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_F32_FLOPS * 1e3
    return Bound(max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations", nbytes, flops)


def launch_bound(name: str, call: dict) -> Bound:
    """``bound_ms`` of one recorded launch (``LaunchShapes.calls``' entry),
    at the least data-dependent work (see the module's docstring)."""
    sh = dict(call["shapes"])
    if name == "depth_scores":
        sh["win_bytes"] = sh["N"] * (call["patch"] + 1) * SECTOR
        return bound_ms(name, sh)
    if name == "pose_refine":
        return bound_ms(name, sh, iterations=1)
    return bound_ms(name, sh, iterations=call["iterations"])


class LaunchShapes:
    """Records each launch of the four kernels while it is open: ``calls``
    maps a kernel's name to a list of dicts (``shapes``, ``iterations``,
    ``patch``), one a launch, a batch of S problems counted as S·N rows."""

    def __init__(self, batch: int = 1):
        import importlib

        self.batch = batch
        self.calls: Dict[str, List[dict]] = {k: [] for k in KERNELS}
        self._saved = {}
        for name, (_, modname) in KERNELS.items():
            mod = importlib.import_module(modname)
            self._saved[name] = (mod, mod._op)
            mod._op = self._wrap(name, mod._op)

    def _wrap(self, name, op):
        import torch

        def call(*args):
            if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
                self.calls[name].append(self._shapes(name, args))
            return op(*args)

        return call

    def _shapes(self, name: str, args: tuple) -> dict:
        B = self.batch
        if name == "lm_align_level":
            _, _, windows, ref_patches = args[:4]
            N, WH, WW = windows.shape[-3:]
            return {"shapes": {"N": B * N, "WH": WH, "WW": WW, "P2": ref_patches.shape[-1],
                               "frozen": int(bool(args[15]))}, "iterations": int(args[13]), "patch": int(args[12])}
        if name == "fa_align_batch":
            windows, ref_patch = args[:2]
            N, WH, WW = windows.shape[-3:]
            return {"shapes": {"N": B * N, "WH": WH, "WW": WW, "P2": ref_patch.shape[-1]},
                    "iterations": int(args[8]), "patch": int(args[7])}
        if name == "pose_refine":
            return {"shapes": {"N": B * args[2].shape[-2]}, "iterations": int(args[5]), "patch": 0}
        windows, cref = args[:2]
        N, WH, WW = windows.shape[-3:]
        patch, steps = int(args[3]), int(args[4])
        return {"shapes": {"N": B * N, "WH": WH, "WW": WW, "P2": patch * patch, "steps": steps},
                "iterations": 0, "patch": patch}

    def close(self):
        for mod, op in self._saved.values():
            mod._op = op


def least_ms_per_launch(calls: List[dict], name: str) -> Optional[float]:
    """The mean least time of a launch of ``name`` over the recorded calls
    (None where none was recorded)."""
    if not calls:
        return None
    return math.fsum(launch_bound(name, c).ms for c in calls) / len(calls)


def share(run, name: str) -> Optional[float]:
    """Kernel ``name``'s share of its roofline in a run's traced slice, in %:
    its launches there times the mean least time of a launch recorded in
    the warm-up, over its kernel time there by its function's name (None
    where either is missing)."""
    s, calls = run.slice, (run.launches or {}).get(name)
    if s is None or not calls:
        return None
    symbol = KERNELS[name][0]
    times = [b - a for k, a, b in s.kernels if symbol in k]
    if not times or sum(times) <= 0:
        return None
    least_ms = least_ms_per_launch(calls, name)
    return 100.0 * len(times) * least_ms * 1e-3 / math.fsum(times)
