"""Trajectory evaluation — copy of ``umeyama_alignment``, ``ate_rmse`` and
``rpe`` from ``sdvo_tpu.dataio.evaluate`` (numpy)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning x→y. x, y: (N, 3) point sets.

    Returns (s, R, t) with y ≈ s·R·x + t (Umeyama 1991 — the standard mono-VO
    evaluation alignment since scale is unobservable)."""
    mx = x.mean(axis=0)
    my = y.mean(axis=0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / x.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc**2).sum() / x.shape[0]
    s = float(np.trace(np.diag(D) @ S) / var_x) if with_scale else 1.0
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after similarity alignment."""
    s, R, t = umeyama_alignment(est_centers, gt_centers, with_scale)
    aligned = (s * (est_centers @ R.T)) + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt_centers) ** 2, axis=-1))))



def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over ``delta``-frame intervals of (N, 4, 4)
    camera→world poses: (translation RMSE, rotation RMSE in degrees)."""
    terrs, rerrs = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        rerrs.append(np.degrees(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1))))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(np.sqrt(np.mean(np.square(rerrs))))
