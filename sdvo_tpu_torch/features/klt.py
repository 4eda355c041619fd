"""Batched pyramidal Lucas-Kanade optical flow — port of
``sdvo_tpu.features.klt`` (``pyramidal_klt``, ``optical_flow_with_gate``)."""

from __future__ import annotations

from typing import Sequence

import torch

from sdvo_tpu_torch.geometry.robust import masked_median
from sdvo_tpu_torch.image.interp import bilinear_sample, patch_offsets


def _track_level(ref_img, cur_img, uv_ref_l, flow, window: int, iterations: int):
    offs = patch_offsets(window, dtype=uv_ref_l.dtype, device=uv_ref_l.device)
    uv = uv_ref_l[:, None, :] + offs[None]
    ref_patch, ref_ok = bilinear_sample(ref_img, uv)
    ex = torch.tensor([1.0, 0.0], dtype=uv.dtype, device=uv.device)
    ey = torch.tensor([0.0, 1.0], dtype=uv.dtype, device=uv.device)
    Ix = 0.5 * (bilinear_sample(ref_img, uv + ex)[0] - bilinear_sample(ref_img, uv - ex)[0])
    Iy = 0.5 * (bilinear_sample(ref_img, uv + ey)[0] - bilinear_sample(ref_img, uv - ey)[0])
    gxx = (Ix * Ix).sum(-1)
    gxy = (Ix * Iy).sum(-1)
    gyy = (Iy * Iy).sum(-1)
    det = gxx * gyy - gxy * gxy
    ok = ref_ok.all(-1) & (det > 1e-6)
    det_safe = torch.where(ok, det, torch.ones_like(det))
    for _ in range(iterations):
        cur_vals, cur_ok = bilinear_sample(cur_img, uv + flow[:, None, :])
        dI = torch.where(cur_ok, ref_patch - cur_vals, torch.zeros_like(cur_vals))
        bx = (dI * Ix).sum(-1)
        by = (dI * Iy).sum(-1)
        step = torch.stack([(gyy * bx - gxy * by) / det_safe, (gxx * by - gxy * bx) / det_safe], -1)
        flow = flow + torch.where(ok[:, None], step, torch.zeros_like(step))
    return flow, ok


def pyramidal_klt(ref_pyramid: Sequence[torch.Tensor], cur_pyramid: Sequence[torch.Tensor],
                  uv_ref: torch.Tensor, window: int = 11, iterations: int = 20,
                  max_error: float = 25.0):
    """Track uv_ref from ref to cur. Returns (uv_cur, status, error)."""
    L = len(ref_pyramid)
    N = uv_ref.shape[0]
    flow = torch.zeros((N, 2), dtype=uv_ref.dtype, device=uv_ref.device)
    ok_all = torch.ones((N,), dtype=torch.bool, device=uv_ref.device)
    for level in range(L - 1, -1, -1):
        flow, ok = _track_level(ref_pyramid[level], cur_pyramid[level], uv_ref * (1.0 / (1 << level)),
                                flow, window, iterations)
        ok_all = ok_all & ok
        if level > 0:
            flow = flow * 2.0
    uv_cur = uv_ref + flow
    offs = patch_offsets(window, dtype=uv_ref.dtype, device=uv_ref.device)
    ref_patch, _ = bilinear_sample(ref_pyramid[0], uv_ref[:, None, :] + offs[None])
    cur_patch, cur_ok = bilinear_sample(cur_pyramid[0], uv_cur[:, None, :] + offs[None])
    err = torch.mean(torch.abs(ref_patch - cur_patch), dim=-1)
    H, W = cur_pyramid[0].shape
    inside = (uv_cur[:, 0] >= 0) & (uv_cur[:, 1] >= 0) & (uv_cur[:, 0] < W - 1) & (uv_cur[:, 1] < H - 1)
    status = ok_all & inside & cur_ok.all(-1) & (err < max_error)
    return uv_cur, status, err


def optical_flow_with_gate(ref_pyramid, cur_pyramid, uv_ref, valid, window: int = 11,
                           iterations: int = 20, disparity_threshold: float = 5.0):
    """Track, drop failures, and report whether the median disparity of the
    surviving tracks exceeds the bootstrap threshold. Returns (uv_cur,
    status, median_disparity, enough_baseline)."""
    uv_cur, status, _ = pyramidal_klt(ref_pyramid, cur_pyramid, uv_ref, window, iterations)
    status = status & valid
    med = masked_median(torch.linalg.norm(uv_cur - uv_ref, dim=-1), status)
    return uv_cur, status, med, med > disparity_threshold
