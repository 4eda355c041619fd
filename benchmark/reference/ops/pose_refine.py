"""K3 — pose-only LM on unit-bearing residuals (the per-frame pose polish).

Port of ``sdvo_tpu.ops.pallas_pose.pose_refine``. ``pose_refine`` is the
wrapper around the operator ``sdvo::pose_refine``: CUDA tensors go to
``csrc/pose_refine.cu``, CPU tensors to ``pose_refine_plain``; under
``torch.func.vmap`` the batch is one launch (one block a problem) on the
card and one plain call a problem on the CPU. Semantics of the Pallas
kernel: residuals f(Tp) − b, one global Tukey scale from the binned MAD over all three columns, the
weights re-evaluated at the current pose every iteration, 6×6 Cholesky, the
left update ``T ← exp(−dx)∘T``, relative-decrease exit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.geometry.se3 import SE3, hat
from benchmark.reference.ops.lm_align import (chol6_solve, lm_accept, lm_result, lm_stats, mad_binned,
                                         pose34, se3_exp_kernel, tukey)

launches = 0
plain_cuda_calls = 0


def _plain(pose, points_w, bearings, valid, max_iters: int, min_rel_decrease: float):
    """Plain PyTorch K3 (float32) from the pose (3, 4); returns what the
    kernel writes: (pose (3, 4), stats (4,) = [chi², n_vis, iterations, 0])."""
    global plain_cuda_calls
    if points_w.is_cuda:
        plain_cuda_calls += 1
    f32 = torch.float32
    dev = points_w.device
    pts = points_w.to(f32)
    brg = bearings.to(f32)
    base_vis = valid.to(f32)[:, None]
    n_vis = torch.clamp(base_vis.sum() * 3.0, min=1.0)
    vis3 = base_vis.expand(-1, 3)

    def residuals(R, t):
        p = pts @ R.T + t
        nrm = torch.sqrt(torch.clamp((p * p).sum(-1, keepdim=True), min=1e-24))
        f = p / nrm
        return (f - brg) * base_vis, p, f, nrm

    def weights_chi2(r):
        c = 4.6851 * torch.clamp(1.4826 * mad_binned(r, vis3, n_vis), min=1e-12)
        w = tukey(r, c) * base_vis
        return w, torch.sum(w * r * r)

    R = pose[:, :3].contiguous()
    t = pose[:, 3].contiguous()
    _, chi = weights_chi2(residuals(R, t)[0])
    lam = torch.full((), 1e-2, dtype=f32, device=dev)
    nu = torch.full((), 2.0, dtype=f32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    for _ in range(max_iters):
        active = ~done
        r, p, f, nrm = residuals(R, t)
        w, _ = weights_chi2(r)
        dfdp = (eye3 - f[:, :, None] * f[:, None, :]) / nrm[:, :, None]
        Jac = dfdp @ torch.cat([eye3.expand(p.shape[0], 3, 3), -hat(p)], -1)  # (N, 3, 6)
        Jw = Jac * w[..., None]
        H = torch.einsum("nia,nib->ab", Jw, Jac)
        g = torch.einsum("nia,ni->a", Jw, r)
        diag = torch.diagonal(H)
        diag_max = torch.maximum(H[0, 0], torch.abs(diag[1:]).max())
        lam_eff = torch.where(it == 0, lam * diag_max, lam)
        dx, okc = chol6_solve(H + lam_eff * eye6, g)
        dR, dt = se3_exp_kernel(-dx)
        R_new = dR @ R
        t_new = dR @ t + dt
        _, chi_n = weights_chi2(residuals(R_new, t_new)[0])
        accept, done_n, lam_next, nu_next = lm_accept(chi, chi_n, dx, g, lam_eff, nu, okc,
                                                      min_rel_decrease)
        accept = accept & active
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        chi = torch.where(accept, chi_n, chi)
        lam = torch.where(active, lam_next, lam)
        nu = torch.where(active, nu_next, nu)
        it = it + active.to(torch.int32)
        done = done | (active & done_n)
    return lm_stats(R, t, chi, n_vis, it)


def _op_cpu(R, t, points_w, bearings, valid, max_iters, min_rel_decrease):
    return _plain(pose34(SE3(R, t)), points_w, bearings, valid, max_iters, min_rel_decrease)


_op = _op_cpu  # the plain version on every device


def pose_refine(T_init: SE3, points_w, bearings, valid, max_iters: int = 8,
                min_rel_decrease: float = 1e-3) -> Tuple[SE3, torch.Tensor, torch.Tensor]:
    """Pose-only LM. points_w (N, 3), bearings (N, 3), valid (N,) bool.
    Computes in float32 and returns (T in ``T_init``'s dtype, rmse,
    iterations)."""
    f32 = torch.float32
    out_pose, out_stats = _op(T_init.rotation, T_init.translation, points_w.to(f32), bearings.to(f32), valid,
                              int(max_iters), float(min_rel_decrease))
    return lm_result(out_pose, out_stats, T_init.dtype)
