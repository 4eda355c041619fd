"""K3 — pose-only LM on unit-bearing residuals (the per-frame pose polish).

Port of ``sdvo_tpu.ops.pallas_pose.pose_refine``. ``pose_refine`` is the
wrapper: CUDA tensors go to ``csrc/pose_refine.cu``, CPU tensors to
``pose_refine_plain``. Semantics of the Pallas kernel: residuals f(Tp) − b,
one global Tukey scale from the binned MAD over all three columns, the
weights re-evaluated at the current pose every iteration, 6×6 Cholesky, the
left update ``T ← exp(−dx)∘T``, relative-decrease exit.
"""

from __future__ import annotations

import sys
from typing import Tuple

import torch

from sdvo_tpu_torch.geometry.se3 import SE3, hat
from sdvo_tpu_torch.ops import build
from sdvo_tpu_torch.ops.lm_align import (chol6_solve, lm_accept, lm_result, mad_binned,
                                         se3_exp_kernel, tukey)

launches = 0
plain_cuda_calls = 0


def pose_refine_plain(T_init: SE3, points_w, bearings, valid, max_iters: int = 8,
                      min_rel_decrease: float = 1e-3):
    """Plain PyTorch K3 (float32). Returns (T, rmse, iterations)."""
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

    R = T_init.rotation.to(f32)
    t = T_init.translation.to(f32)
    _, chi = weights_chi2(residuals(R, t)[0])
    lam = torch.tensor(1e-2, dtype=f32, device=dev)
    nu = torch.tensor(2.0, dtype=f32, device=dev)
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
    dtype = T_init.dtype
    return SE3(R.to(dtype), t.to(dtype)), torch.sqrt(chi / n_vis).to(dtype), it


def kernel_launcher(T_init: SE3, points_w, bearings, valid, max_iters: int = 8,
                    min_rel_decrease: float = 1e-3):
    """Checks the inputs, allocates the outputs and returns (launch, out_pose
    (3, 4), out_stats (4,) = [chi², n_vis, iterations, 0]): ``launch()``
    enqueues the kernel alone, on the current stream, and counts it."""
    dev = points_w.device
    N = points_w.shape[0]
    f32 = torch.float32
    if N < 1:
        raise ValueError("pose_refine: the kernel takes at least one observation")
    pose = torch.cat([T_init.rotation.to(f32), T_init.translation.to(f32)[:, None]], 1).contiguous()
    vis = valid.to(f32).contiguous()
    build.check_inputs(
        "pose_refine", dev,
        {"pose": (3, 4), "points": (N, 3), "bearings": (N, 3), "valid": (N,)},
        pose=pose, points=points_w, bearings=bearings, valid=vis,
    )
    out_pose = torch.empty((3, 4), dtype=f32, device=dev)
    out_stats = torch.empty((4,), dtype=f32, device=dev)
    args = (pose.data_ptr(), points_w.data_ptr(), bearings.data_ptr(), vis.data_ptr(),
            out_pose.data_ptr(), out_stats.data_ptr(), N, max_iters, float(min_rel_decrease))
    launch = build.launcher(sys.modules[__name__], "pose_refine", "sdvo_pose_refine", args, dev,
                            (pose, vis, points_w, bearings))
    return launch, out_pose, out_stats


def pose_refine(T_init: SE3, points_w, bearings, valid, max_iters: int = 8,
                min_rel_decrease: float = 1e-3) -> Tuple[SE3, torch.Tensor, torch.Tensor]:
    """Pose-only LM. points_w (N, 3), bearings (N, 3), valid (N,) bool.
    Returns (T, rmse, iterations)."""
    if not points_w.is_cuda:
        return pose_refine_plain(T_init, points_w, bearings, valid, max_iters, min_rel_decrease)
    launch, out_pose, out_stats = kernel_launcher(T_init, points_w, bearings, valid, max_iters,
                                                  min_rel_decrease)
    launch()
    return lm_result(out_pose, out_stats, T_init.dtype)
