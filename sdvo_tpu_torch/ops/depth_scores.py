"""K4 — ZSSD score per (filter, epipolar step) row.

Port of ``sdvo_tpu.ops.pallas_depth.depth_scores``. ``depth_scores`` is the
wrapper around the operator ``sdvo::depth_scores``: CUDA tensors go to
``csrc/depth_scores.cu`` (four rows a warp, their footprints copied into
shared memory), CPU tensors to ``depth_scores_plain``; under
``torch.func.vmap`` the S·R rows of S sequences are one launch on the card
(one plain call per sequence on the CPU). Each row samples a P×P bilinear
patch from its window, subtracts the patch mean and sums |· − cref|, cref
being the zero-mean warped reference patch of the row's filter; ``ok`` is
the value-sampler support rule. The R rows are R / ``steps`` filters of
``steps`` consecutive rows each, and ``cref`` holds one patch a filter: row
r reads ``cref[r // steps]`` (``steps = 1``: a patch a row, the Pallas
kernel's interface, which takes the patches repeated per step).
"""

from __future__ import annotations

import sys
from typing import Tuple

import torch

from sdvo_tpu_torch.ops import build
from sdvo_tpu_torch.ops.window_sampler import sample_windows

launches = 0
plain_cuda_calls = 0
MAX_PATCH = 7  # the kernel's footprint: P + 1 ≤ 8 rows and columns


def depth_scores_plain(windows, cref, offs, patch: int = 7, steps: int = 1):
    """Plain PyTorch K4. windows (R, WH, WW), cref (R / steps, P²), offs
    (R, 2). Returns (score (R,), ok (R,) bool)."""
    global plain_cuda_calls
    if windows.is_cuda:
        plain_cuda_calls += 1
    f32 = torch.float32
    vals, ok = sample_windows(windows.to(f32), offs.to(f32), patch)
    mean_v = vals.sum(1, keepdim=True) / float(patch * patch)
    cref = torch.repeat_interleave(cref.to(f32), steps, dim=0)
    return torch.abs((vals - mean_v) - cref).sum(1), ok


def kernel_launcher(windows, cref, offs, patch: int = 7, steps: int = 1):
    """Checks the inputs, allocates the outputs and returns (launch, score
    (R,), ok (R,) as 0/1 floats): ``launch()`` enqueues the kernel alone, on
    the current stream, and counts it. Leading axes (S sequences of R rows)
    are S·R rows of one launch."""
    dev = windows.device
    lead = tuple(windows.shape[:-3])
    R, WH, WW = windows.shape[-3:]
    P2 = patch * patch
    if not 1 <= patch <= MAX_PATCH or WW % 4 or steps < 1 or R % steps:
        raise ValueError(f"depth_scores: the kernel takes patch ≤ {MAX_PATCH}, a window width that is "
                         f"a multiple of 4 and R a multiple of steps; got patch {patch}, WW {WW}, "
                         f"R {R}, steps {steps}")
    build.check_inputs("depth_scores", dev,
                       {k: lead + v for k, v in {"windows": (R, WH, WW), "cref": (R // steps, P2),
                                                 "offs": (R, 2)}.items()},
                       windows=windows, cref=cref, offs=offs)
    if windows.data_ptr() % 16:
        raise ValueError("depth_scores: windows must start on 16 bytes")
    score = torch.empty(lead + (R,), dtype=torch.float32, device=dev)
    ok = torch.empty(lead + (R,), dtype=torch.float32, device=dev)
    args = (windows.data_ptr(), cref.data_ptr(), offs.data_ptr(), score.data_ptr(), ok.data_ptr(),
            score.numel(), WH, WW, patch, steps)
    launch = build.launcher(sys.modules[__name__], "depth_scores", "sdvo_depth_scores", args, dev,
                            (windows, cref, offs, score, ok))
    return launch, score, ok


def _op_cpu(windows, cref, offs, patch, steps):
    score, ok = depth_scores_plain(windows, cref, offs, patch, steps)
    return score, ok.to(torch.float32)


def _op_cuda(*args):
    launch, score, ok = kernel_launcher(*args)
    launch()
    return score, ok


_op = build.define_op("depth_scores", "(Tensor windows, Tensor cref, Tensor offs, int patch, int steps) "
                      "-> (Tensor, Tensor)", _op_cpu, _op_cuda)


def depth_scores(windows, cref, offs, patch: int = 7, steps: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """ZSSD scores of every row. Returns (score (R,) float32, ok (R,) bool)."""
    score, ok = _op(windows, cref, offs, int(patch), int(steps))
    return score, ok > 0.5
