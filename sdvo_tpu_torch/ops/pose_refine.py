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

import sys
from typing import Tuple

import torch

from sdvo_tpu_torch.geometry.se3 import SE3, hat
from sdvo_tpu_torch.ops import build
from sdvo_tpu_torch.ops.lm_align import (chol6_solve, lm_accept, lm_result, lm_stats, mad_binned,
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


def pose_refine_plain(T_init: SE3, points_w, bearings, valid, max_iters: int = 8,
                      min_rel_decrease: float = 1e-3):
    """Plain PyTorch K3 (float32). Returns (T, rmse, iterations)."""
    return lm_result(*_plain(pose34(T_init), points_w, bearings, valid, max_iters, min_rel_decrease),
                     T_init.dtype)


def kernel_launcher(T_init: SE3, points_w, bearings, valid, max_iters: int = 8,
                    min_rel_decrease: float = 1e-3):
    """Checks the inputs, allocates the outputs and returns (launch, out_pose
    (3, 4), out_stats (4,) = [chi², n_vis, iterations, 0]): ``launch()``
    enqueues the kernel alone, on the current stream, and counts it. With a
    leading (S,) axis on every tensor (``T_init`` included) it is S problems
    in one launch, with outputs (S, 3, 4) and (S, 4)."""
    dev = points_w.device
    lead = tuple(points_w.shape[:-2])
    N = points_w.shape[-2]
    f32 = torch.float32
    if len(lead) > 1 or N < 1:
        raise ValueError(f"pose_refine: batch {lead} or N {N} beyond what the kernel takes")
    pose = pose34(T_init)
    vis = valid.to(f32).contiguous()
    build.check_inputs(
        "pose_refine", dev,
        {k: lead + v for k, v in {"pose": (3, 4), "points": (N, 3), "bearings": (N, 3),
                                  "valid": (N,)}.items()},
        pose=pose, points=points_w, bearings=bearings, valid=vis,
    )
    out_pose = torch.empty(lead + (3, 4), dtype=f32, device=dev)
    out_stats = torch.empty(lead + (4,), dtype=f32, device=dev)
    args = (pose.data_ptr(), points_w.data_ptr(), bearings.data_ptr(), vis.data_ptr(),
            out_pose.data_ptr(), out_stats.data_ptr(), N, max_iters, float(min_rel_decrease),
            lead[0] if lead else 1)
    launch = build.launcher(sys.modules[__name__], "pose_refine", "sdvo_pose_refine", args, dev,
                            (pose, vis, points_w, bearings, out_pose, out_stats))
    return launch, out_pose, out_stats


def _op_cpu(R, t, points_w, bearings, valid, max_iters, min_rel_decrease):
    return _plain(pose34(SE3(R, t)), points_w, bearings, valid, max_iters, min_rel_decrease)


def _op_cuda(R, t, *args):
    launch, out_pose, out_stats = kernel_launcher(SE3(R, t), *args)
    launch()
    return out_pose, out_stats


_op = build.define_op("pose_refine", "(Tensor R, Tensor t, Tensor points_w, Tensor bearings, "
                      "Tensor valid, int max_iters, float min_rel_decrease) -> (Tensor, Tensor)",
                      _op_cpu, _op_cuda)


def pose_refine(T_init: SE3, points_w, bearings, valid, max_iters: int = 8,
                min_rel_decrease: float = 1e-3) -> Tuple[SE3, torch.Tensor, torch.Tensor]:
    """Pose-only LM. points_w (N, 3), bearings (N, 3), valid (N,) bool.
    Computes in float32 and returns (T in ``T_init``'s dtype, rmse,
    iterations)."""
    f32 = torch.float32
    out_pose, out_stats = _op(T_init.rotation, T_init.translation, points_w.to(f32), bearings.to(f32), valid,
                              int(max_iters), float(min_rel_decrease))
    return lm_result(out_pose, out_stats, T_init.dtype)
