"""Two-view depth — from ``sdvo_tpu_torch.geometry.triangulation``."""

from __future__ import annotations

import torch

from benchmark.reference.geometry.se3 import SE3


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


