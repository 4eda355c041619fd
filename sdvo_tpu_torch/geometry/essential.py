"""Essential-matrix RANSAC and pose recovery — port of
``sdvo_tpu.geometry.essential`` (``find_essential_ransac``, ``recover_pose``).

All hypotheses are solved at once: (S, 8) samples drawn by a top-8 of masked
uniforms, a batched normalized 8-point solve, one (S, N) Sampson scoring pass,
then six least-squares refits on the inlier set keeping the best seen. The
uniforms are an argument (or drawn from a ``torch.Generator``) so a test can
hand both implementations the same random numbers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.geometry.triangulation import sampson_distance, triangulate_two_view_depth


def topk_stable(x: torch.Tensor, k: int, dim: int = -1):
    """``jax.lax.top_k`` semantics: the k largest along ``dim``, ties resolved
    to the lower index (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def _normalize_points(x: torch.Tensor, mask: torch.Tensor):
    """Masked Hartley normalization over the N axis of x (..., N, 2)."""
    w = mask.to(x.dtype)
    cnt = torch.clamp(w.sum(-1), min=1.0)
    mean = (x * w[..., None]).sum(-2) / cnt[..., None]
    d = torch.linalg.norm(x - mean[..., None, :], dim=-1) * w
    scale = math.sqrt(2.0) / torch.clamp(d.sum(-1) / cnt, min=1e-12)
    z = torch.zeros_like(scale)
    o = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, z, -scale * mean[..., 0]], -1),
        torch.stack([z, scale, -scale * mean[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    return (x - mean[..., None, :]) * scale[..., None, None], T


def eight_point(x_ref: torch.Tensor, x_cur: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized 8-point E from (..., N, 2) normalized-plane coordinates,
    projected to singular values (1, 1, 0)."""
    if mask is None:
        mask = torch.ones(x_ref.shape[:-1], dtype=torch.bool, device=x_ref.device)
    xr, Tr = _normalize_points(x_ref, mask)
    xc, Tc = _normalize_points(x_cur, mask)
    u1, v1 = xr[..., 0], xr[..., 1]
    u2, v2 = xc[..., 0], xc[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], -1)
    A = A * mask[..., None].to(A.dtype)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    F = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    F = Tc.transpose(-1, -2) @ F @ Tr
    U, _, Vt = torch.linalg.svd(F)
    S = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=F.dtype, device=F.device))
    return U @ S @ Vt


def decompose_essential(E: torch.Tensor):
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[:, 2]


def recover_pose(E: torch.Tensor, x_ref: torch.Tensor, x_cur: torch.Tensor,
                 mask: torch.Tensor) -> Tuple[SE3, torch.Tensor]:
    """Cheirality vote over the 4 (R, t) candidates. Returns (T_cur_ref with
    unit translation, positive-depth mask of the winner)."""
    R1, R2, t = decompose_essential(E)
    one = torch.ones_like(x_ref[..., :1])
    f_ref = torch.cat([x_ref, one], -1)
    f_cur = torch.cat([x_cur, one], -1)
    Rs, ts, goods, counts = [], [], [], []
    for R, tv in ((R1, t), (R1, -t), (R2, t), (R2, -t)):
        T = SE3(R, tv)
        d_ref = triangulate_two_view_depth(T, f_ref, f_cur)
        d_cur = T.apply(d_ref[..., None] * f_ref)[..., 2]
        good = (d_ref > 0) & (d_cur > 0) & mask
        Rs.append(R)
        ts.append(tv)
        goods.append(good)
        counts.append(good.to(torch.int64).sum())
    best = torch.argmax(torch.stack(counts))
    return SE3(torch.stack(Rs)[best], torch.stack(ts)[best]), torch.stack(goods)[best]


def find_essential_ransac(x_ref: torch.Tensor, x_cur: torch.Tensor, mask: torch.Tensor,
                          uniforms: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          num_hypotheses: int = 256, threshold: float = 1e-6):
    """Batched RANSAC over the 8-point solver. ``uniforms`` (S, N) in [0, 1)
    select each hypothesis' sample (top-8 among valid rows); when absent they
    are drawn from ``generator``. Returns (E, inlier mask, inlier count)."""
    N = x_ref.shape[0]
    S = num_hypotheses
    if uniforms is None:
        uniforms = torch.rand((S, N), generator=generator, dtype=x_ref.dtype,
                              device=generator.device if generator is not None else x_ref.device)
    uniforms = uniforms.to(device=x_ref.device, dtype=x_ref.dtype)
    enough = mask.to(torch.int64).sum() >= 8
    g = torch.where(mask[None, :], uniforms, torch.full_like(uniforms, -1.0))
    _, idx = topk_stable(g, 8)  # (S, 8)
    Es = eight_point(x_ref[idx], x_cur[idx])  # (S, 3, 3)
    one = torch.ones_like(x_ref[..., :1])
    h_ref = torch.cat([x_ref, one], -1)
    h_cur = torch.cat([x_cur, one], -1)
    inl = (sampson_distance(Es, h_ref, h_cur) < threshold) & mask[None, :]
    counts = inl.to(torch.int64).sum(-1)
    best = torch.argmax(counts)
    bestE, bestInl, bestCount = Es[best], inl[best], counts[best]
    inl_c = bestInl
    # least-squares refits on the current inlier set, keeping the best seen
    for _ in range(6):
        E_p = eight_point(x_ref, x_cur, inl_c)
        inl_p = (sampson_distance(E_p, h_ref, h_cur) < threshold) & mask
        count_p = inl_p.to(torch.int64).sum()
        better = count_p >= bestCount
        bestE = torch.where(better, E_p, bestE)
        bestInl = torch.where(better, inl_p, bestInl)
        bestCount = torch.maximum(count_p, bestCount)
        inl_c = inl_p
    return bestE, bestInl & enough, torch.where(enough, bestCount, torch.zeros_like(bestCount))
