"""Batched feature alignment off cached reference patch tables — port of the
kernel branch of ``sdvo_tpu.align.feature_alignment.align_features_2d_cached``.

Each candidate gets one ``window``-row gradient window around its predicted
position; K2 (``sdvo_tpu_torch.ops.fa_align``) runs the per-feature LM.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sdvo_tpu_torch.ops.fa_align import fa_align_batch
from sdvo_tpu_torch.ops.window_sampler import window_gather


def align_features_2d_cached(cur_gradient: torch.Tensor, ref_patch, gx, gy, uv_init, live,
                             patch_size: int = 5, max_iterations: int = 10, window: int = 24,
                             contrast_threshold: float = 1.0
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (uv (N, 2), rmse (N,), converged (N,) bool)."""
    win, org, org_ok = window_gather(cur_gradient, uv_init, window)
    return fa_align_batch(win, ref_patch, gx, gy, uv_init, org, live & org_ok,
                          patch=patch_size, max_iters=max_iterations,
                          contrast_threshold=contrast_threshold)
