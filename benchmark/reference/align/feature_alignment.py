"""Batched feature alignment — ``align_features_2d_cached`` from
``sdvo_tpu_torch.align.feature_alignment``.

Each candidate gets one ``window``-row gradient window around its predicted
position; K2 (``benchmark.reference.ops.fa_align``, its plain version) runs
the per-feature LM in float32: a float64 caller's tables are cast at its
boundary and the results come back in ``uv_init``'s dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.ops.fa_align import fa_align_batch
from benchmark.reference.ops.window_sampler import window_gather


def align_features_2d_cached(cur_gradient: torch.Tensor, ref_patch, gx, gy, uv_init, live,
                             patch_size: int = 5, max_iterations: int = 10, window: int = 24,
                             contrast_threshold: float = 1.0
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (uv (N, 2), rmse (N,), converged (N,) bool)."""
    win, org, org_ok = window_gather(cur_gradient, uv_init, window)
    f32 = torch.float32
    uv, rmse, conv = fa_align_batch(win.to(f32), ref_patch.to(f32), gx.to(f32), gy.to(f32),
                                    uv_init.to(f32), org.to(f32), live & org_ok, patch=patch_size,
                                    max_iters=max_iterations, contrast_threshold=contrast_threshold)
    return uv.to(uv_init.dtype), rmse.to(uv_init.dtype), conv
