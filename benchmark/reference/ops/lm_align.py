"""K1 — one pyramid level of photometric LM in one launch.

Port of ``sdvo_tpu.ops.pallas_lm.lm_align_level``. ``lm_align_level`` is the
wrapper around the operator ``sdvo::lm_align_level``: a CUDA tensor goes to
the hand-written kernel (``csrc/lm_align.cu``), a CPU tensor to
``lm_align_level_plain``, the plain PyTorch version of the same function.
Under ``torch.func.vmap`` the op's rule solves every problem of the batch in
one launch of the kernel (one block each) on the card, and calls the plain
version once per problem on the CPU. Both follow the Pallas semantics —
16-bin two-stage binned median for the robust scale, Nielsen-damped 6×6
Cholesky, ``T ← T∘exp(−dx)``, accept on a chi² decrease, relative-decrease
exit — not the XLA path's histogram MAD. The plain version runs the
``while`` loop as ``max_iters`` masked iterations (a finished solve leaves
its state unchanged), so it needs no host synchronisation.

Also holds the shared scalar helpers of the LM kernels' plain versions:
``bin_median`` / ``mad_binned`` (``_bin_median`` / ``_mad_bisect``),
``se3_exp_kernel`` (``_se3_exp_scalar``) and ``chol6_solve``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.geometry.se3 import SE3, hat
from benchmark.reference.ops.window_sampler import sample_windows

MAD_BINS = 16

launches = 0  # kernel launches (CUDA tensors)
plain_cuda_calls = 0  # plain-version calls on CUDA tensors (parity checks only)


# ------------------------------------------------------------- shared helpers
def bin_median(x: torch.Tensor, vis: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               half_n: torch.Tensor, stages: int = 2) -> torch.Tensor:
    """Masked median by 16 cumulative bin counts with in-bin interpolation,
    zoomed over ``stages`` rounds (``pallas_lm._bin_median``)."""
    bins = MAD_BINS
    b = torch.arange(bins, dtype=x.dtype, device=x.device)
    xf = x.reshape(-1)
    vf = vis.reshape(-1)
    med = hi
    for _ in range(stages):
        span = torch.clamp(hi - lo, min=1e-12)
        thr = lo + ((b + 1.0) / bins) * span
        cnts = torch.where(xf[None, :] <= thr[:, None], vf[None, :], 0.0).sum(-1)
        prev = torch.cat([cnts.new_zeros(1), cnts[:-1]])
        hit = (prev < half_n) & (cnts >= half_n)
        any_hit = hit.any()
        k = torch.argmax(hit.to(torch.int32)).reshape(1)  # indexed on the device, not read back
        prev_k, cnts_k, kf = prev.index_select(0, k)[0], cnts.index_select(0, k)[0], b.index_select(0, k)[0]
        frac = (half_n - prev_k) / torch.clamp(cnts_k - prev_k, min=1.0)
        med = torch.where(any_hit, lo + (kf + frac) * (span / bins), med)
        new_lo = torch.where(any_hit, lo + kf * (span / bins), lo)
        new_hi = torch.where(any_hit, lo + (kf + 1.0) * (span / bins), hi)
        lo, hi = new_lo, new_hi
    return med


def mad_binned(r: torch.Tensor, vis: torch.Tensor, n_vis: torch.Tensor) -> torch.Tensor:
    """MAD = median(|r − median(r)|) over visible entries, two binned passes
    (``pallas_lm._mad_bisect``; ``vis`` is a 0/1 float mask shaped like r)."""
    half_n = 0.5 * n_vis
    big = torch.full((), 3.0e38, dtype=r.dtype, device=r.device)
    lo = torch.where(vis > 0.5, r, big).min()
    hi = torch.where(vis > 0.5, r, -big).max()
    med = bin_median(r, vis, lo, hi, half_n)
    dev = torch.abs(r - med)
    hi2 = torch.where(vis > 0.5, dev, torch.zeros_like(dev)).max()
    return bin_median(dev, vis, torch.zeros_like(hi2), hi2, half_n)


def tukey(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    w = (1.0 - (r * r) / (c * c)) ** 2
    return torch.where(torch.abs(r) <= c, w, torch.zeros_like(w))


def se3_exp_kernel(tau: torch.Tensor):
    """SE3 exp with the kernels' small-angle branch (``_se3_exp_scalar``):
    returns (R (3,3), t (3,))."""
    v, w = tau[:3], tau[3:]
    theta2 = torch.sum(w * w)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    return R, V @ v


def chol6_solve(H: torch.Tensor, g: torch.Tensor):
    """(H) x = g by Cholesky; ok False on a non-positive pivot or a
    non-finite solution, and then x = 0."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(g[:, None], L)[:, 0]
    ok = (info == 0) & torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x)), ok


def lm_accept(chi, chi_n, dx, g, lam_eff, nu, okc, min_rel_decrease):
    """The kernels' shared LM bookkeeping: (accept, done, lam', nu')."""
    pred = torch.sum(dx * (lam_eff * dx + g))
    rho = (chi - chi_n) / torch.clamp(pred, min=1e-30)
    success = (chi - chi_n) > 0.0
    lam_next = torch.where(success, lam_eff * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                           lam_eff * nu)
    nu_next = torch.where(success, torch.full_like(nu, 2.0), nu * 2.0)
    small = torch.sum(dx * dx) < 1e-16
    rel_dec = (chi - chi_n) / torch.clamp(chi, min=1e-30)
    rel_pred = pred / torch.clamp(chi, min=1e-30)
    done = small | ~okc | (success & (rel_dec < min_rel_decrease)) | (rel_pred < 0.1 * min_rel_decrease)
    return success & ~small, done, lam_next, nu_next


# -------------------------------------------------------------- plain version
def pose34(T: SE3) -> torch.Tensor:
    """[R | t] (..., 3, 4) in float32: how the LM kernels take a pose."""
    f32 = torch.float32
    return torch.cat([T.rotation.to(f32), T.translation.to(f32)[..., None]], -1).contiguous()


def _plain(pose, windows, ref_patches, J, points_ref, origins, visible, fx: float, fy: float,
           cx: float, cy: float, patch: int, max_iters: int, min_rel_decrease: float,
           freeze_sigma: bool = False):
    """Plain PyTorch K1 (float32) from the pose (3, 4); returns what the
    kernel writes: (pose (3, 4), stats (4,) = [chi², n_vis, iterations, 0]).
    With ``freeze_sigma`` the Tukey cutoff of the entry pose weights every
    candidate (``pallas_lm.py:349-354,380``)."""
    global plain_cuda_calls
    if windows.is_cuda:
        plain_cuda_calls += 1
    f32 = torch.float32
    dev = windows.device
    win = windows.to(f32)
    patches = ref_patches.to(f32)
    Jf = J.to(f32)
    pts = points_ref.to(f32)
    org = origins.to(f32)
    base_vis = visible.to(f32)
    N, P2 = patches.shape

    def residuals(R, t):
        p = pts @ R.T + t
        zs = torch.where(p[:, 2] < 1e-6, torch.ones_like(p[:, 2]), p[:, 2])
        u = fx * p[:, 0] / zs + cx - org[:, 0]
        v = fy * p[:, 1] / zs + cy - org[:, 1]
        vals, ok = sample_windows(win, torch.stack([u, v], -1), patch)
        vis1 = ((base_vis > 0.5) & ok & (p[:, 2] > 1e-6)).to(f32)
        return (vals - patches) * vis1[:, None], vis1

    def weights_chi2(r, vis1, c=None):
        vis2 = vis1[:, None].expand(N, P2)
        n_vis = torch.clamp(vis2.sum(), min=1.0)
        if c is None:
            c = 4.6851 * torch.clamp(1.4826 * mad_binned(r, vis2, n_vis), min=1e-12)
        w = tukey(r, c) * vis2
        return w, torch.sum(w * r * r), c

    R = pose[:, :3].contiguous()
    t = pose[:, 3].contiguous()
    r_acc, vis_acc = residuals(R, t)
    w_acc, chi, c0 = weights_chi2(r_acc, vis_acc)
    lam = torch.full((), 1e-2, dtype=f32, device=dev)
    nu = torch.full((), 2.0, dtype=f32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    for _ in range(max_iters):
        active = ~done
        Jw = Jf * (w_acc * vis_acc[:, None])[..., None]
        g = (Jw * r_acc[..., None]).sum((0, 1))
        H = torch.einsum("npi,npj->ij", Jw, Jf)
        diag = torch.diagonal(H)
        diag_max = torch.maximum(H[0, 0], torch.abs(diag[1:]).max())
        lam_eff = torch.where(it == 0, lam * diag_max, lam)
        dx, okc = chol6_solve(H + lam_eff * eye6, g)
        dR, dt = se3_exp_kernel(-dx)
        R_new = R @ dR
        t_new = R @ dt + t
        r_n, vis_n = residuals(R_new, t_new)
        w_n, chi_n, _ = weights_chi2(r_n, vis_n, c0 if freeze_sigma else None)
        accept, done_n, lam_next, nu_next = lm_accept(chi, chi_n, dx, g, lam_eff, nu, okc,
                                                      min_rel_decrease)
        accept = accept & active
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        chi = torch.where(accept, chi_n, chi)
        r_acc = torch.where(accept, r_n, r_acc)
        vis_acc = torch.where(accept, vis_n, vis_acc)
        w_acc = torch.where(accept, w_n, w_acc)
        lam = torch.where(active, lam_next, lam)
        nu = torch.where(active, nu_next, nu)
        it = it + active.to(torch.int32)
        done = done | (active & done_n)
    n_vis = torch.clamp(vis_acc.sum() * P2, min=1.0)
    return lm_stats(R, t, chi, n_vis, it)


def lm_stats(R, t, chi, n_vis, it):
    """What an LM kernel writes, from the plain version's final state."""
    return torch.cat([R, t[:, None]], 1), torch.stack([chi, n_vis, it.to(chi.dtype), torch.zeros_like(chi)])


# ------------------------------------------------------------------- wrapper
def lm_result(out_pose, out_stats, dtype=torch.float32):
    """What an LM kernel wrote — out_pose (..., 3, 4), out_stats (..., 4) =
    [chi², n_vis, iterations, 0] — as the wrappers return it: (T, rmse,
    iterations)."""
    T = SE3(out_pose[..., :3].to(dtype), out_pose[..., 3].to(dtype))
    return (T, torch.sqrt(out_stats[..., 0] / out_stats[..., 1]).to(dtype),
            out_stats[..., 2].to(torch.int32))


def _op_cpu(R, t, *args):
    return _plain(pose34(SE3(R, t)), *args)


_op = _op_cpu  # the plain version on every device


def lm_align_level(T_init: SE3, windows, ref_patches, J, points_ref, origins, visible,
                   fx: float, fy: float, cx: float, cy: float, patch: int = 5,
                   max_iters: int = 12, min_rel_decrease: float = 1e-3, freeze_sigma: bool = False
                   ) -> Tuple[SE3, torch.Tensor, torch.Tensor]:
    """One LM pyramid level. windows (N, WH, WW), ref_patches (N, P²),
    J (N, P², 6), points_ref (N, 3), origins (N, 2), visible (N,) bool;
    level-scaled intrinsics. With ``freeze_sigma`` the Tukey cutoff stays at
    its value at ``T_init`` for the whole level. Returns (T, rmse,
    iterations)."""
    out_pose, out_stats = _op(T_init.rotation, T_init.translation, windows, ref_patches, J,
                              points_ref, origins, visible, float(fx), float(fy), float(cx), float(cy),
                              int(patch), int(max_iters), float(min_rel_decrease), bool(freeze_sigma))
    return lm_result(out_pose, out_stats, T_init.dtype)
