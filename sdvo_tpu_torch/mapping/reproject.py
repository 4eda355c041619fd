"""Map reprojection on the host path — port of
``sdvo_tpu.mapping.reproject`` (``project_points``, ``reproject_map``):
project the arena's landmarks into the current frame, keep one candidate per
grid cell, and refine the kept ones with the batched feature alignment (K2
through ``align_features_2d_cached``).

* candidates: every valid observation of a GOOD or CANDIDATE point, one per
  point by close-view selection (the observation whose viewing ray is closest
  to the current one, none at 60° or more);
* projection of the candidates on the device;
* cell binning, the per-cell pick (GOOD first, a random tiebreak), the
  shuffle and the cap (150) in numpy, in the reference's call order on the
  same ``numpy.random.Generator``: equal seeds give equal draws and so equal
  match sets;
* one K2 launch at the fixed capacity, then the succeeded/failed counters,
  promotion and kill rules.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sdvo_tpu_torch.align.feature_alignment import align_features_2d_cached
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.mapping.device_map import PointType


def project_points(T_cur_w: SE3, points_w: torch.Tensor, valid: torch.Tensor, fx, fy, cx, cy,
                   width, height, border=8.0):
    """Project landmark positions into the current image. Returns (uv (P, 2),
    visible (P,))."""
    p_cam = T_cur_w.apply(points_w)
    z = p_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * p_cam[..., 0] / z_safe + cx
    v = fy * p_cam[..., 1] / z_safe + cy
    uv = torch.stack([u, v], dim=-1)
    vis = (
        valid & (z > 1e-6)
        & (u >= border) & (v >= border) & (u < width - border) & (v < height - border)
    )
    return uv, vis


class ReprojectionResult(NamedTuple):
    pt_slot: np.ndarray  # (S,) arena point slots of accepted matches
    uv: np.ndarray  # (S, 2) refined current-frame positions
    error: np.ndarray  # (S,)
    n_candidates: int
    n_trials: int


def reproject_map(
    T_cur_w: SE3,
    cur_gradient: torch.Tensor,  # (H, W), on the device the frame is tracked on
    arena,
    cell_size: int,
    max_matches: int = 150,
    max_error: float = 50.0,
    patch_size: int = 5,
    rng: Optional[np.random.Generator] = None,
) -> ReprojectionResult:
    """Full reprojection pass for one frame.

    ``arena`` is a MapArena (``arena.intrinsics`` = (fx, fy, cx, cy));
    candidate features are all valid (kf, feature) observations whose points
    are GOOD or CANDIDATE; within a cell GOOD goes before CANDIDATE.
    """
    H, W = cur_gradient.shape
    rng = rng or np.random.default_rng(0)

    # --- gather candidates (host bookkeeping) ------------------------------
    ks, rows = np.nonzero(arena.feat_valid & (arena.feat_point >= 0))
    pts = arena.feat_point[ks, rows]
    keep = arena.pt_valid[pts] & (
        (arena.pt_type[pts] == int(PointType.GOOD)) | (arena.pt_type[pts] == int(PointType.CANDIDATE))
    )
    ks, rows, pts = ks[keep], rows[keep], pts[keep]
    # deduplicate points (a point observed by several KFs projects once) by
    # CLOSE-VIEW observation selection: pick the observation whose viewing ray
    # makes the smallest angle with the current frame's ray to the point, and
    # drop observations at >= 60 deg — they are unusable as warp/patch
    # references (Point::getCloseViewObs, src/point.cpp:118-181).
    R_cw = T_cur_w.rotation.cpu().numpy().astype(np.float64)
    t_cw = T_cur_w.translation.cpu().numpy().astype(np.float64)
    cur_center_w = -R_cw.T @ t_cw
    pt_pos = arena.pt_pos[pts]
    dir_cur = cur_center_w[None] - pt_pos
    dir_cur /= np.maximum(np.linalg.norm(dir_cur, axis=-1, keepdims=True), 1e-12)
    kf_R = arena.kf_pose[ks, :3, :3]
    kf_t = arena.kf_pose[ks, :3, 3]
    kf_center = -np.einsum("kij,kj->ki", kf_R.transpose(0, 2, 1), kf_t)
    dir_obs = kf_center - pt_pos
    dir_obs /= np.maximum(np.linalg.norm(dir_obs, axis=-1, keepdims=True), 1e-12)
    cos_view = np.sum(dir_cur * dir_obs, axis=-1)
    usable = cos_view > 0.5  # cos 60°, src/point.cpp:170-176
    ks, rows, pts, cos_view = ks[usable], rows[usable], pts[usable], cos_view[usable]
    # best (largest cosine) observation first, so np.unique's first-occurrence
    # pick is the close-view one
    order = np.argsort(-cos_view, kind="stable")
    ks, rows, pts = ks[order], rows[order], pts[order]
    _, first = np.unique(pts, return_index=True)
    ks, rows, pts = ks[first], rows[first], pts[first]
    n_cand = len(pts)
    if n_cand == 0:
        return ReprojectionResult(np.empty(0, np.int64), np.empty((0, 2)), np.empty(0), 0, 0)

    # --- project on device --------------------------------------------------
    # the caller passes the intrinsics through an arena attribute. The points
    # keep their float64 (the pose is widened), as JAX's promotion does
    fx, fy, cx, cy = arena.intrinsics
    dev = cur_gradient.device
    pos = torch.as_tensor(arena.pt_pos[pts], device=dev)
    T_wide = SE3(T_cur_w.rotation.to(pos.dtype), T_cur_w.translation.to(pos.dtype))
    uv_proj, vis = project_points(
        T_wide, pos, torch.ones((n_cand,), dtype=torch.bool, device=dev), fx, fy, cx, cy, W, H
    )
    uv_proj = uv_proj.cpu().numpy()
    vis = vis.cpu().numpy()

    # mark projection failures (Point quality counters, src/map.cpp:505-579)
    arena.pt_failed[pts[~vis]] += 1

    ks, rows, pts, uv_proj = ks[vis], rows[vis], pts[vis], uv_proj[vis]
    if len(pts) == 0:
        return ReprojectionResult(np.empty(0, np.int64), np.empty((0, 2)), np.empty(0), n_cand, 0)

    # --- grid binning: one candidate per cell, GOOD preferred, shuffled visit
    cell = (uv_proj[:, 1].astype(int) // cell_size) * (W // cell_size + 1) + (
        uv_proj[:, 0].astype(int) // cell_size
    )
    quality = (arena.pt_type[pts] == int(PointType.GOOD)).astype(int)
    # sort: by cell, then by -quality, random tiebreak
    jitter = rng.uniform(size=len(pts))
    order = np.lexsort((jitter, -quality, cell))
    cell_sorted = cell[order]
    first_in_cell = np.ones(len(order), bool)
    first_in_cell[1:] = cell_sorted[1:] != cell_sorted[:-1]
    sel = order[first_in_cell]
    # cap (max 150 matches/frame, src/map.cpp:484-487), shuffled cell order
    rng.shuffle(sel)
    sel = sel[:max_matches]

    ks_s, rows_s, pts_s, uv_s = ks[sel], rows[sel], pts[sel], uv_proj[sel]
    S = len(sel)

    # --- batched feature alignment off the arena's CACHED reference patch
    # tables (fixed capacity): per-frame device work touches only the current
    # image — no per-frame keyframe-stack rebuild (the reference re-samples
    # the host patch per candidate per frame, src/feature_alignment.cpp:64-110)
    cap = max_matches
    P2 = arena.align_patch_size ** 2
    dt = cur_gradient.dtype
    uv_init = np.zeros((cap, 2))
    ref_patch = np.zeros((cap, P2), np.float32)
    ref_gx = np.zeros((cap, P2), np.float32)
    ref_gy = np.zeros((cap, P2), np.float32)
    live = np.zeros(cap, bool)
    uv_init[:S] = uv_s
    ref_patch[:S] = arena.feat_patch[ks_s, rows_s]
    ref_gx[:S] = arena.feat_gx[ks_s, rows_s]
    ref_gy[:S] = arena.feat_gy[ks_s, rows_s]
    live[:S] = arena.feat_patch_ok[ks_s, rows_s]

    def to_dev(a, dtype=dt):
        return torch.as_tensor(a, device=dev).to(dtype)

    uv_out, err, conv = align_features_2d_cached(
        cur_gradient, to_dev(ref_patch), to_dev(ref_gx), to_dev(ref_gy), to_dev(uv_init),
        to_dev(live, torch.bool), patch_size=patch_size,
    )
    uv_out = uv_out.cpu().numpy()[:S]
    err = err.cpu().numpy()[:S]
    conv = conv.cpu().numpy()[:S]

    good = conv & (err < max_error)
    arena.pt_succeeded[pts_s[good]] += 1
    arena.pt_failed[pts_s[~good]] += 1
    # promote candidates observed often; demote chronically failing points
    promote = arena.pt_succeeded >= 3
    arena.pt_type[promote & (arena.pt_type == int(PointType.CANDIDATE))] = int(PointType.GOOD)
    kill = (arena.pt_failed > 15) & (arena.pt_failed > 3 * np.maximum(arena.pt_succeeded, 1))
    for p in np.nonzero(kill & arena.pt_valid)[0]:
        arena.remove_point(int(p))

    return ReprojectionResult(pts_s[good], uv_out[good], err[good], n_cand, S)
