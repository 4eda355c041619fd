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

from typing import Tuple

import torch

from benchmark.reference.ops.window_sampler import sample_windows

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


def _op_cpu(windows, cref, offs, patch, steps):
    score, ok = depth_scores_plain(windows, cref, offs, patch, steps)
    return score, ok.to(torch.float32)


_op = _op_cpu  # the plain version on every device


def depth_scores(windows, cref, offs, patch: int = 7, steps: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """ZSSD scores of every row. Returns (score (R,) float32, ok (R,) bool)."""
    score, ok = _op(windows, cref, offs, int(patch), int(steps))
    return score, ok > 0.5
