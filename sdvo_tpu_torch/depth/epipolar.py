"""Batched epipolar-line ZSSD matching — port of the window path of
``sdvo_tpu.depth.epipolar.epipolar_search`` (with ``affine_warp_matrix``,
``warp_ref_patches``).

Every filter samples a fixed number of positions along its segment; each
(filter, step) row gets a ``patch+5``-row window from the current image and
K4 (``sdvo_tpu_torch.ops.depth_scores``) scores it against the filter's
zero-mean reference patch, warped by the inverse first-order affine warp.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sdvo_tpu_torch.device import constant
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.geometry.triangulation import triangulate_two_view_depth
from sdvo_tpu_torch.image.interp import patch_offsets
from sdvo_tpu_torch.ops.depth_scores import depth_scores
from sdvo_tpu_torch.ops.window_sampler import window_gather


def _project(p, fx, fy, cx, cy):
    z = torch.where(torch.abs(p[..., 2]) < 1e-9, torch.full_like(p[..., 2], 1e-9), p[..., 2])
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], dim=-1)


def affine_warp_matrix(T_cur_ref: SE3, uv_ref, depth_ref, fx, fy, cx, cy, half_patch: int):
    """(F, 2, 2) first-order warp ref-patch → cur-patch, columns = the
    projected (+h, 0) and (0, +h) offsets divided by h."""

    def backproject(uv):
        b = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy,
                         torch.ones_like(uv[..., 0])], dim=-1)
        return b / torch.linalg.norm(b, dim=-1, keepdim=True)

    h = float(half_patch)
    du = constant((h, 0.0), uv_ref.dtype, uv_ref.device)
    dv = constant((0.0, h), uv_ref.dtype, uv_ref.device)
    c_c = _project(T_cur_ref.apply(backproject(uv_ref) * depth_ref[:, None]), fx, fy, cx, cy)
    c_u = _project(T_cur_ref.apply(backproject(uv_ref + du) * depth_ref[:, None]), fx, fy, cx, cy)
    c_v = _project(T_cur_ref.apply(backproject(uv_ref + dv) * depth_ref[:, None]), fx, fy, cx, cy)
    return torch.stack([(c_u - c_c) / h, (c_v - c_c) / h], dim=-1)


def _inv2x2(A):
    a, b, c, d = A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) < 1e-9, torch.ones_like(det), det)
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def warp_ref_patches(ref_patches, A_inv, patch_size: int):
    """Resample (F, P²) reference patches through A⁻¹ (bilinear inside the
    patch, border-clamped, the edge +1 tap folded onto the edge sample)."""
    F = ref_patches.shape[0]
    P = patch_size
    half = P // 2
    dtype = ref_patches.dtype
    offs = patch_offsets(P, dtype, ref_patches.device)
    q = torch.einsum("fij,pj->fpi", A_inv, offs)
    qx = torch.clamp(q[..., 0] + half, 0.0, P - 1.0)
    qy = torch.clamp(q[..., 1] + half, 0.0, P - 1.0)
    x0 = torch.floor(qx)
    y0 = torch.floor(qy)
    wx = (qx - x0)[..., None]
    wy = (qy - y0)[..., None]
    grid = ref_patches.reshape(F, P, P)
    ix = x0.to(torch.int64)
    iy = y0.to(torch.int64)
    ar = torch.arange(P, device=ref_patches.device)
    selx0 = (ix[..., None] == ar).to(dtype)
    selx1 = (ix[..., None] + 1 == ar).to(dtype)
    sely0 = (iy[..., None] == ar).to(dtype)
    sely1 = (iy[..., None] + 1 == ar).to(dtype)
    selx = selx0 * (1.0 - wx) + selx1 * wx + selx0 * wx * (ix == P - 1).to(dtype)[..., None]
    sely = sely0 * (1.0 - wy) + sely1 * wy + sely0 * wy * (iy == P - 1).to(dtype)[..., None]
    rows = torch.einsum("fpy,fyx->fpx", sely, grid)
    return torch.sum(rows * selx, dim=-1)


def zssd_score(ref_patch: torch.Tensor, cur_patch: torch.Tensor) -> torch.Tensor:
    """Zero-mean SAD over the last axis (the reference's ``computeScore``:
    despite the ZSSD name it sums |·|)."""
    r = ref_patch - ref_patch.mean(dim=-1, keepdim=True)
    c = cur_patch - cur_patch.mean(dim=-1, keepdim=True)
    return torch.sum(torch.abs(r - c), dim=-1)


def epipolar_search(T_cur_ref: SE3, cur: torch.Tensor, ref_patches, bearings_ref, mu, inv_min,
                    inv_max, valid, fx, fy, cx, cy, patch_size: int = 7, num_steps: int = 16
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (depth_ref (F,), matched (F,), best_uv (F, 2))."""
    H, W = cur.shape
    dtype = mu.dtype
    half = patch_size // 2
    P2 = patch_size * patch_size

    def clampuv(uv):
        return torch.stack([torch.clamp(uv[..., 0], 0.0, W - 1.0),
                            torch.clamp(uv[..., 1], 0.0, H - 1.0)], dim=-1)

    d_center = 1.0 / torch.clamp(mu, min=1e-9)
    d_min = 1.0 / torch.clamp(inv_min, min=1e-9)
    d_max = 1.0 / torch.clamp(inv_max, min=1e-9)
    p_center = T_cur_ref.apply(bearings_ref * d_center[:, None])
    uv_center = _project(p_center, fx, fy, cx, cy)
    inside = ((uv_center[..., 0] >= 0) & (uv_center[..., 0] < W)
              & (uv_center[..., 1] >= 0) & (uv_center[..., 1] < H))
    live = valid & (p_center[..., 2] > 0.0) & inside

    uv_min = clampuv(_project(T_cur_ref.apply(bearings_ref * d_min[:, None]), fx, fy, cx, cy))
    uv_max = clampuv(_project(T_cur_ref.apply(bearings_ref * d_max[:, None]), fx, fy, cx, cy))
    epi = uv_max - uv_min
    norm = torch.linalg.norm(epi, dim=-1)

    z_ref = torch.clamp(bearings_ref[..., 2] * d_center, min=1e-9)
    uv_ref = torch.stack([fx * bearings_ref[..., 0] * d_center / z_ref + cx,
                          fy * bearings_ref[..., 1] * d_center / z_ref + cy], dim=-1)
    A = affine_warp_matrix(T_cur_ref, uv_ref, d_center, fx, fy, cx, cy, half)
    ref_warped = warp_ref_patches(ref_patches, _inv2x2(A), patch_size)

    t = (torch.arange(num_steps, dtype=dtype, device=mu.device) + 0.5) / num_steps
    locs = uv_min[:, None, :] + t[None, :, None] * epi[:, None, :]  # (F, K, 2)
    Fn, K = locs.shape[:2]
    locs_f = locs.reshape(Fn * K, 2)
    win, org, ok_w = window_gather(cur, locs_f, win_h=patch_size + 5)
    cref = ref_warped - ref_warped.mean(dim=-1, keepdim=True)  # one patch a filter: rows f·K .. f·K + K − 1
    sc, ok_s = depth_scores(win.to(torch.float32), cref.to(torch.float32).contiguous(),
                            (locs_f - org).to(torch.float32).contiguous(), patch=patch_size, steps=K)
    scores = sc.reshape(Fn, K).to(dtype)
    patch_ok = (ok_w & ok_s).reshape(Fn, K)
    scores = torch.where(patch_ok, scores, torch.full_like(scores, float("inf")))

    short = norm < 2.0
    best_score, best_k = torch.min(scores, dim=-1)
    best_uv_long = torch.gather(locs, 1, best_k[:, None, None].expand(Fn, 1, 2))[:, 0, :]
    best_uv = torch.where(short[:, None], 0.5 * (uv_min + uv_max), best_uv_long)
    score_ok = short | (best_score < P2 * 128.0)

    bearing_cur = torch.stack([(best_uv[..., 0] - cx) / fx, (best_uv[..., 1] - cy) / fy,
                               torch.ones_like(best_uv[..., 0])], dim=-1)
    depth = triangulate_two_view_depth(T_cur_ref, bearings_ref, bearing_cur)
    matched = live & score_ok & (depth > 1e-6)
    return depth, matched, best_uv
