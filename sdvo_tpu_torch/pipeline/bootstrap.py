"""Two-frame map bootstrap — port of ``sdvo_tpu.pipeline.bootstrap.bootstrap_two_view``.

KLT → median-disparity gate → essential-matrix RANSAC → Sampson correction →
cheirality vote → two-view triangulation → scale normalisation (median depth
→ ``map_scale_factor``) → two-view BA with chi² pruning (``run_ba``). It runs once per
sequence, on whatever device the pyramids lie on, in the dtype of
``uv_ref`` (the port bootstraps in float64, the host pose chain's dtype).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from sdvo_tpu_torch.ba.bundle_adjustment import BAObservations, BASettings, two_view_ba
from sdvo_tpu_torch.features.klt import optical_flow_with_gate
from sdvo_tpu_torch.geometry.essential import find_essential_ransac, recover_pose
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.geometry.triangulation import sampson_correction, triangulate_two_view_depth


class BootstrapResult(NamedTuple):
    success: bool
    reason: str
    T_cur_ref: Optional[np.ndarray]  # 4x4, scaled
    uv_ref: Optional[np.ndarray]  # (N, 2) inlier features in ref
    uv_cur: Optional[np.ndarray]  # (N, 2) inlier features in cur
    points_w: Optional[np.ndarray]  # (N, 3) world = ref camera
    median_depth: float = 0.0
    min_depth: float = 0.0


def _fail(reason):
    return BootstrapResult(False, reason, None, None, None, None)


def bootstrap_two_view(ref_pyramid, cur_pyramid, uv_ref: torch.Tensor, cam, uniforms=None,
                       generator: Optional[torch.Generator] = None, min_disparity: float = 5.0,
                       min_inliers: int = 50, map_scale_factor: float = 1.0, klt_window: int = 11,
                       ransac_hypotheses: int = 256, ransac_threshold_px: float = 1.0,
                       run_ba: bool = True) -> BootstrapResult:
    """``uniforms`` (S, N) are RANSAC's sample draws (see
    ``find_essential_ransac``); without them they come from ``generator``.
    ``run_ba=False`` skips the two-view BA and its pruning: the result is the
    scaled RANSAC pose and triangulation (``median_depth`` then that of the
    unscaled triangulation, as in the JAX function)."""
    N = uv_ref.shape[0]
    dev = uv_ref.device
    valid = torch.ones((N,), dtype=torch.bool, device=dev)
    uv_cur, status, med_disp, enough = optical_flow_with_gate(
        ref_pyramid.images, cur_pyramid.images, uv_ref, valid, window=klt_window,
        disparity_threshold=min_disparity)
    if not bool(enough):
        return _fail(f"insufficient disparity ({float(med_disp):.2f}px)")

    x_ref = cam.normalized(uv_ref)[..., :2]
    x_cur = cam.normalized(uv_cur)[..., :2]
    thr = (ransac_threshold_px / float(cam.fx)) ** 2
    E, inliers, count = find_essential_ransac(x_ref, x_cur, status, uniforms=uniforms,
                                              generator=generator,
                                              num_hypotheses=ransac_hypotheses, threshold=thr)
    if int(count) < min_inliers:
        return _fail(f"too few E-inliers ({int(count)})")

    one = torch.ones_like(x_ref[..., :1])
    h_ref_c, h_cur_c = sampson_correction(E, torch.cat([x_ref, one], -1), torch.cat([x_cur, one], -1))
    x_ref_c = h_ref_c[..., :2] / h_ref_c[..., 2:3]
    x_cur_c = h_cur_c[..., :2] / h_cur_c[..., 2:3]
    T_rel, cheir = recover_pose(E, x_ref_c, x_cur_c, inliers)
    f_ref = torch.cat([x_ref_c, one], -1)
    f_cur = torch.cat([x_cur_c, one], -1)
    d_ref = triangulate_two_view_depth(T_rel, f_ref, f_cur)
    p_ref = d_ref[..., None] * f_ref
    z_cur = T_rel.apply(p_ref)[..., 2]
    good = (inliers & cheir & (d_ref > 1e-6) & (z_cur > 1e-6)).cpu().numpy()
    if good.sum() < min_inliers:
        return _fail(f"too few triangulated ({int(good.sum())})")

    median_depth = float(np.median(z_cur.cpu().numpy()[good]))
    scale = map_scale_factor / median_depth
    p_w = p_ref.cpu().numpy()[good] * scale
    uv_ref_in = uv_ref.cpu().numpy()[good]
    uv_cur_in = uv_cur.cpu().numpy()[good]

    R1 = T_rel.rotation.cpu().numpy()
    t1 = T_rel.translation.cpu().numpy() * scale
    if run_ba:
        # two-view BA, first camera fixed, then chi² pruning
        f64 = torch.float64
        P = p_w.shape[0]
        poses = SE3(torch.stack([torch.eye(3, dtype=f64, device=dev), T_rel.rotation.to(f64)]),
                    torch.stack([torch.zeros(3, dtype=f64, device=dev), T_rel.translation.to(f64) * scale]))
        obs = BAObservations(
            cam_idx=torch.cat([torch.zeros(P, dtype=torch.int64), torch.ones(P, dtype=torch.int64)]).to(dev),
            pt_idx=torch.cat([torch.arange(P)] * 2).to(dev),
            uv=torch.as_tensor(np.concatenate([uv_ref_in, uv_cur_in]), device=dev),
            valid=torch.ones((2 * P,), dtype=torch.bool, device=dev),
        )
        poses_out, pts_out, chi2_obs, _ = two_view_ba(
            poses, torch.as_tensor(p_w, device=dev), obs, torch.zeros((P,), dtype=torch.bool, device=dev),
            cam.fx, cam.fy, cam.cx, cam.cy, settings=BASettings(iterations=10, huber_delta=2.0))
        chi2_np = chi2_obs.cpu().numpy().reshape(2, P)
        keep = (chi2_np < 5.991).all(axis=0)
        if keep.sum() < min_inliers:
            # the 95 % gate assumes ~1 px noise: keep the best 70 % by worst-view chi² instead
            worst = chi2_np.max(axis=0)
            thr_k = max(5.991, float(np.quantile(worst, 0.7)))
            logging.getLogger("sdvo_tpu_torch.Bootstrap").warning(
                "two-view BA chi2 gate 5.991 kept %d < %d points; relaxed to %.2f",
                int((chi2_np < 5.991).all(axis=0).sum()), min_inliers, thr_k)
            keep = worst <= thr_k
        p_w = pts_out.cpu().numpy()[keep]
        uv_ref_in = uv_ref_in[keep]
        uv_cur_in = uv_cur_in[keep]
        R1 = poses_out.rotation[1].cpu().numpy()
        t1 = poses_out.translation[1].cpu().numpy()
        z_after = (p_w @ R1.T + t1)[:, 2]
        pos = z_after > 1e-6
        p_w, uv_ref_in, uv_cur_in = p_w[pos], uv_ref_in[pos], uv_cur_in[pos]
        median_depth = float(np.median(z_after[pos]))
    if len(p_w) < min_inliers:
        return _fail(f"too few after BA ({len(p_w)})")
    T44 = np.eye(4)
    T44[:3, :3] = R1
    T44[:3, 3] = t1
    return BootstrapResult(True, "ok", T44, uv_ref_in, uv_cur_in, p_w, median_depth,
                           float(np.min((p_w @ R1.T + t1)[:, 2])))
