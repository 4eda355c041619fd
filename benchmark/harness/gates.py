"""Trajectory accuracy against the scene's truth, printed beside every run
and not compared: a frozen copy of ``bench_torch.gates``' arithmetic and of
``sdvo_tpu_torch/dataio/evaluate.py``'s ``umeyama_alignment`` /
``ate_rmse`` (numpy)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning x→y ((N, 3) point sets): (s, R, t)
    with y ≈ s·R·x + t (Umeyama 1991; monocular scale is free)."""
    mx, my = x.mean(axis=0), y.mean(axis=0)
    xc, yc = x - mx, y - my
    cov = yc.T @ xc / x.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / x.shape[0]
    s = float(np.trace(np.diag(D) @ S) / var_x) if with_scale else 1.0
    return s, R, my - s * R @ mx


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE of camera centres after similarity
    alignment."""
    s, R, t = umeyama_alignment(est, gt, with_scale)
    aligned = s * (est @ R.T) + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))


def centre(T: np.ndarray) -> np.ndarray:
    """The camera centre −Rᵀt of a world→camera 4×4 pose."""
    return -T[:3, :3].T @ T[:3, 3]


def accuracy(trajectory: List[Optional[np.ndarray]], truth: List[np.ndarray]) -> dict:
    """Failed frames, scale-aligned ATE, path length and drift (ATE / path)
    of the tracked frames of ``trajectory`` (world→camera 4×4 or None)
    against the truth of the same frames."""
    ok = [i for i, T in enumerate(trajectory) if T is not None]
    failed = len(trajectory) - len(ok)
    if len(ok) < 3:
        return {"frames": len(trajectory), "failed": failed, "ate_m": None, "path_m": None, "drift": None}
    est = np.asarray([centre(np.asarray(trajectory[i], np.float64)) for i in ok])
    gt = np.asarray([centre(truth[i]) for i in ok])
    ate = ate_rmse(est, gt) if np.all(np.isfinite(est)) else float("inf")
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    return {"frames": len(trajectory), "failed": failed, "ate_m": ate, "path_m": path,
            "drift": ate / max(path, 1e-9)}
