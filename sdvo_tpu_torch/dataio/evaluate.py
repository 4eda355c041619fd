"""Trajectory evaluation — copy of ``umeyama_alignment`` and ``ate_rmse`` from
``sdvo_tpu.dataio.evaluate`` (numpy)."""

from __future__ import annotations

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

