"""Batched feature alignment — port of ``align_features_2d`` and the kernel
branch of ``align_features_2d_cached`` from
``sdvo_tpu.align.feature_alignment``.

Each candidate gets one ``window``-row gradient window around its predicted
position; K2 (``sdvo_tpu_torch.ops.fa_align``) runs the per-feature LM. K2 is
a float32 kernel, as the Pallas kernel is: a float64 caller's tables are cast
at its boundary and the results come back in ``uv_init``'s dtype.
``align_features_2d`` samples the reference patches and their gradients from
the host gradient images on every call (``image.stack``) and hands off to
``align_features_2d_cached``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sdvo_tpu_torch.image.stack import sample_patches_grad_multi
from sdvo_tpu_torch.ops.fa_align import fa_align_batch
from sdvo_tpu_torch.ops.window_sampler import window_gather


def align_features_2d(ref_gradient: torch.Tensor, cur_gradient: torch.Tensor, uv_ref, uv_init, valid,
                      patch_size: int = 5, max_iterations: int = 10, host_idx=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """N features at once: ``ref_gradient`` is the host's level-0 gradient
    image (H, W), or a (K, H, W) stack with ``host_idx`` (N,) naming each
    feature's host (zeros by default). A feature is live where it is valid
    and ``uv_ref`` lies ``patch_size//2 + 2`` px inside the image. Returns
    (uv (N, 2), rmse (N,), converged (N,) bool)."""
    half = patch_size // 2
    border = half + 2
    H, W = cur_gradient.shape
    if ref_gradient.ndim == 2:
        ref_gradient = ref_gradient[None]
    if host_idx is None:
        host_idx = torch.zeros((uv_ref.shape[0],), dtype=torch.int32, device=uv_ref.device)
    ref_patch, gx, gy, _ = sample_patches_grad_multi(ref_gradient, host_idx, uv_ref, patch_size)
    ref_inside = ((uv_ref[:, 0] >= border) & (uv_ref[:, 1] >= border)
                  & (uv_ref[:, 0] < W - border) & (uv_ref[:, 1] < H - border))
    return align_features_2d_cached(cur_gradient, ref_patch, gx, gy, uv_init, valid & ref_inside,
                                    patch_size, max_iterations)


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
