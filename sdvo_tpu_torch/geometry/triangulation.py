"""Triangulation, two-view depth, Sampson correction and distance, and the
reprojection error — port of ``sdvo_tpu.geometry.triangulation``."""

from __future__ import annotations

import torch

from sdvo_tpu_torch.geometry.se3 import SE3


def triangulate_dlt_homogeneous(P_ref: torch.Tensor, P_cur: torch.Tensor, uv_ref: torch.Tensor,
                                uv_cur: torch.Tensor) -> torch.Tensor:
    """Homogeneous DLT from two 3×4 projection matrices, batched over the
    leading dims of uv: the right singular vector of the smallest singular
    value of the 4×4 system. Returns points (..., 3)."""
    def row_pair(P, uv):
        return uv[..., 0:1] * P[..., 2, :] - P[..., 0, :], uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]

    r0, r1 = row_pair(P_ref, uv_ref)
    r2, r3 = row_pair(P_cur, uv_cur)
    _, _, Vh = torch.linalg.svd(torch.stack([r0, r1, r2, r3], dim=-2))
    X = Vh[..., 3, :]
    return X[..., :3] / X[..., 3:4]


def reprojection_error(T_wc: SE3, cam, pts_w: torch.Tensor, uv_obs: torch.Tensor) -> torch.Tensor:
    """Pixel distance of each world point's projection from its observation."""
    return torch.linalg.norm(cam.project(T_wc.apply(pts_w)) - uv_obs, dim=-1)


def triangulate_two_view_depth(T_cur_ref: SE3, f_ref: torch.Tensor, f_cur: torch.Tensor) -> torch.Tensor:
    """Depth along the reference bearing from the 2-view least-squares system
    ``[R f_ref | -f_cur] [d_ref, d_cur]ᵀ = -t``. Returns d_ref (...,)."""
    Rf = T_cur_ref.rotate(f_ref)
    A = torch.stack([Rf, -f_cur], dim=-1)  # (..., 3, 2)
    AtA = torch.einsum("...ij,...ik->...jk", A, A)
    Atb = torch.einsum("...ij,...i->...j", A, -T_cur_ref.translation.expand(Rf.shape))
    det = AtA[..., 0, 0] * AtA[..., 1, 1] - AtA[..., 0, 1] * AtA[..., 1, 0]
    det = torch.where(torch.abs(det) < 1e-18, torch.sign(det) * 1e-18 + 1e-18, det)
    return (AtA[..., 1, 1] * Atb[..., 0] - AtA[..., 0, 1] * Atb[..., 1]) / det


def _epipolar_terms(E, x_ref, x_cur):
    Ex = torch.einsum("ij,...j->...i", E, x_ref)
    Etxp = torch.einsum("ji,...j->...i", E, x_cur)
    err = torch.sum(x_cur * Ex, dim=-1)
    denom = Ex[..., 0] ** 2 + Ex[..., 1] ** 2 + Etxp[..., 0] ** 2 + Etxp[..., 1] ** 2
    return Ex, Etxp, err, denom


def sampson_correction(E: torch.Tensor, x_ref: torch.Tensor, x_cur: torch.Tensor):
    """First-order correction of homogeneous (z=1) correspondences toward the
    epipolar manifold; returns (x_ref', x_cur')."""
    Ex, Etxp, err, denom = _epipolar_terms(E, x_ref, x_cur)
    lam = err / torch.clamp(denom, min=1e-18)
    z = torch.zeros_like(lam)
    dx_ref = lam[..., None] * torch.stack([Etxp[..., 0], Etxp[..., 1], z], dim=-1)
    dx_cur = lam[..., None] * torch.stack([Ex[..., 0], Ex[..., 1], z], dim=-1)
    return x_ref - dx_ref, x_cur - dx_cur


def sampson_distance(E: torch.Tensor, x_ref: torch.Tensor, x_cur: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance — the RANSAC scoring metric. ``E`` may carry a
    leading batch dim (S, 3, 3) against (N, 3) points, giving (S, N)."""
    if E.ndim == 3:
        Ex = torch.einsum("sij,nj->sni", E, x_ref)
        Etxp = torch.einsum("sji,nj->sni", E, x_cur)
        err = torch.sum(x_cur[None] * Ex, dim=-1)
    else:
        Ex = torch.einsum("ij,...j->...i", E, x_ref)
        Etxp = torch.einsum("ji,...j->...i", E, x_cur)
        err = torch.sum(x_cur * Ex, dim=-1)
    denom = Ex[..., 0] ** 2 + Ex[..., 1] ** 2 + Etxp[..., 0] ** 2 + Etxp[..., 1] ** 2
    return err * err / torch.clamp(denom, min=1e-18)
