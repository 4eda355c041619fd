"""Windowed bundle adjustment via the Schur complement — port of
``sdvo_tpu.ba.bundle_adjustment`` (``BAObservations``, ``BASettings``,
``build_point_table``, ``local_ba``, ``two_view_ba``).

Per-observation blocks accumulate into the camera, landmark and per-point
camera-block matrices with ``index_add`` — the natural GPU form of the JAX
package's one-hot matmul fill-in. The reduced (6K × 6K) camera system is
solved by a dense Cholesky; fixed cameras are pinned by identity rows. The
optional structure pre-solve of the reference (off by default) is not
ported, and the solver takes no point table (the reference no longer reads
it).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sdvo_tpu_torch.geometry import se3
from sdvo_tpu_torch.geometry.se3 import SE3


class BAObservations(NamedTuple):
    cam_idx: torch.Tensor  # (M,) camera index into the pose window
    pt_idx: torch.Tensor  # (M,) point index
    uv: torch.Tensor  # (M, 2) pixel observation
    valid: torch.Tensor  # (M,) bool


class BASettings(NamedTuple):
    iterations: int = 10
    huber_delta: float = 2.0
    init_lambda: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    chi2_prune: float = 5.991
    min_rel_decrease: float = 0.0  # 0 = run all iterations


def build_point_table(pt_idx: np.ndarray, valid: np.ndarray, num_points: int, max_obs: int) -> np.ndarray:
    """Host-side per-point observation-index table (P, max_obs), padded -1."""
    table = -np.ones((num_points, max_obs), dtype=np.int32)
    fill = np.zeros(num_points, dtype=np.int32)
    for m, (p, ok) in enumerate(zip(np.asarray(pt_idx), np.asarray(valid))):
        if ok and p >= 0 and fill[p] < max_obs:
            table[p, fill[p]] = m
            fill[p] += 1
    return table


def _inv3x3(H: torch.Tensor) -> torch.Tensor:
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    sing = torch.abs(det) < 1e-12
    det_s = torch.where(sing, torch.ones_like(det), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    inv = adj / det_s[..., None, None]
    return torch.where(sing[..., None, None], torch.zeros_like(inv), inv)


def _huber_w(r: torch.Tensor, delta: float) -> torch.Tensor:
    n = torch.linalg.norm(r, dim=-1)
    return torch.where(n <= delta, torch.ones_like(n), delta / torch.clamp(n, min=1e-12))


def local_ba(poses: SE3, points: torch.Tensor, obs: BAObservations, fixed_cam: torch.Tensor,
             fixed_pt: torch.Tensor, fx: float, fy: float, cx: float, cy: float,
             settings: BASettings = BASettings()) -> Tuple[SE3, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Schur-complement LM over a keyframe window. Returns (poses, points,
    chi2 per observation, total chi2)."""
    K = poses.translation.shape[0]
    P = points.shape[0]
    M = obs.cam_idx.shape[0]
    dtype = points.dtype
    dev = points.device
    cam = obs.cam_idx.to(torch.int64)
    pid = obs.pt_idx.to(torch.int64)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def residuals(R_all, t_all, pts_all):
        R = R_all[cam]
        p_cam = torch.einsum("mij,mj->mi", R, pts_all[pid]) + t_all[cam]
        z = p_cam[:, 2]
        z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        r = torch.stack([fx * p_cam[:, 0] / z_safe + cx, fy * p_cam[:, 1] / z_safe + cy], -1) - obs.uv
        ok = obs.valid & (z > 1e-6) & ~fixed_pt[pid]
        return torch.where(ok[:, None], r, torch.zeros_like(r)), ok, p_cam, R, z_safe

    def chi2_of(r, w, ok):
        return torch.where(ok, w * (r * r).sum(-1), torch.zeros_like(w)).sum()

    R_c, t_c, pts = poses.rotation, poses.translation, points
    r0, ok0, _, _, _ = residuals(R_c, t_c, pts)
    chi = chi2_of(r0, _huber_w(r0, settings.huber_delta), ok0)
    lam = torch.tensor(settings.init_lambda, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    free_c = (~fixed_cam).to(dtype)
    free6 = torch.repeat_interleave(free_c, 6)
    for _ in range(settings.iterations):
        active = ~done
        r, ok, p_cam, R, z_safe = residuals(R_c, t_c, pts)
        okf = ok.to(dtype)
        w = _huber_w(r, settings.huber_delta) * okf
        x, y = p_cam[:, 0], p_cam[:, 1]
        iz = 1.0 / z_safe
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        Jpix = torch.stack([torch.stack([fx * iz, zero, -fx * x * iz2], -1),
                            torch.stack([zero, fy * iz, -fy * y * iz2], -1)], -2)  # (M, 2, 3)
        dpdxi = torch.cat([eye3.expand(M, 3, 3), -se3.hat(p_cam)], -1)  # (M, 3, 6)
        Jc = Jpix @ dpdxi * (free_c[cam] * okf)[:, None, None]
        Jp = Jpix @ R * okf[:, None, None]
        JcW = Jc * w[:, None, None]
        JpW = Jp * w[:, None, None]
        Hcc = torch.zeros((K, 6, 6), dtype=dtype, device=dev).index_add(
            0, cam, torch.einsum("mri,mrj->mij", JcW, Jc))
        gc = torch.zeros((K, 6), dtype=dtype, device=dev).index_add(0, cam, torch.einsum("mri,mr->mi", JcW, r))
        Hpp = torch.zeros((P, 3, 3), dtype=dtype, device=dev).index_add(
            0, pid, torch.einsum("mri,mrj->mij", JpW, Jp))
        gp = torch.zeros((P, 3), dtype=dtype, device=dev).index_add(0, pid, torch.einsum("mri,mr->mi", JpW, r))
        Hpp_inv = _inv3x3(Hpp + lam * eye3)
        # per-point camera-block matrices W[p, k] (6×3), then the Schur fill-in
        Wcp = torch.einsum("mri,mrj->mij", JcW, Jp) * okf[:, None, None]
        Wd = torch.zeros((P * K, 6, 3), dtype=dtype, device=dev).index_add(0, pid * K + cam, Wcp)
        Wd = Wd.reshape(P, K, 6, 3)
        Yd = Wd @ Hpp_inv[:, None]
        Wr = Wd.permute(1, 2, 0, 3).reshape(K * 6, P * 3)
        Yr = Yd.permute(1, 2, 0, 3).reshape(K * 6, P * 3)
        S = -(Yr @ Wr.T)
        S = S.reshape(K, 6, K, 6)
        diag_blocks = torch.arange(K, device=dev)
        S[diag_blocks, :, diag_blocks, :] += Hcc + lam * eye6
        S = S.reshape(K * 6, K * 6)
        g = gc.reshape(K * 6) - Yr @ gp.reshape(P * 3)
        S = S * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
        g = g * free6
        L, info = torch.linalg.cholesky_ex(S + 1e-10 * torch.eye(6 * K, dtype=dtype, device=dev))
        ok_chol = (info == 0) & torch.isfinite(L).all()
        L = torch.where(ok_chol, L, torch.eye(6 * K, dtype=dtype, device=dev))
        dc = torch.cholesky_solve(g[:, None], L)[:, 0]
        dc = torch.where(ok_chol, dc, torch.zeros_like(dc)).reshape(K, 6)
        WTdc = (Wr.T @ dc.reshape(K * 6)).reshape(P, 3)
        dp = (Hpp_inv @ (gp - WTdc)[..., None])[..., 0]
        dp = torch.where(fixed_pt[:, None], torch.zeros_like(dp), dp)
        delta = se3.exp(-dc)
        R_new = delta.rotation @ R_c
        t_new = torch.einsum("kij,kj->ki", delta.rotation, t_c) + delta.translation
        pts_new = pts - dp
        r_n, ok_n, _, _, _ = residuals(R_new, t_new, pts_new)
        chi_n = chi2_of(r_n, _huber_w(r_n, settings.huber_delta) * ok_n.to(dtype), ok_n)
        better = (chi_n < chi) & active
        R_c = torch.where(better, R_new, R_c)
        t_c = torch.where(better, t_new, t_c)
        pts = torch.where(better, pts_new, pts)
        lam = torch.where(active, torch.where(better, lam * settings.lambda_down, lam * settings.lambda_up), lam)
        if settings.min_rel_decrease > 0.0:
            rel = (chi - chi_n) / torch.clamp(chi, min=torch.finfo(dtype).tiny)
            done = done | (better & (rel < settings.min_rel_decrease))
        chi = torch.where(better, chi_n, chi)
    r_f, ok_f, _, _, _ = residuals(R_c, t_c, pts)
    chi2_obs = torch.where(ok_f, (r_f * r_f).sum(-1), torch.zeros_like(r_f[:, 0]))
    return SE3(R_c, t_c), pts, chi2_obs, chi


def two_view_ba(poses: SE3, points, obs: BAObservations, fixed_pt, fx, fy, cx, cy,
                settings: BASettings = BASettings()):
    """First camera fixed, second camera and the points free."""
    fixed_cam = torch.tensor([True, False], device=points.device)
    return local_ba(poses, points, obs, fixed_cam, fixed_pt, fx, fy, cx, cy, settings=settings)
