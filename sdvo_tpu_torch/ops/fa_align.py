"""K2 — batched 2D + illumination feature alignment (N independent LMs).

Port of ``sdvo_tpu.ops.pallas_fa.fa_align_batch``. ``fa_align_batch`` is the
wrapper around the operator ``sdvo::fa_align_batch``: CUDA tensors go to
``csrc/fa_align.cu`` (one warp per feature, which leaves its loop when the
feature stalls), CPU tensors to ``fa_align_batch_plain``. The features are
independent rows, so under ``torch.func.vmap`` the S·N rows of S sequences
are one launch on the card (one plain call per sequence on the CPU). Semantics of the Pallas kernel, which
differ from the XLA path of ``align_features_2d_cached``: the per-feature
median is a 10-step bisection, the 10 iterations are unrolled, and a feature
freezes the moment it stalls.
"""

from __future__ import annotations

import sys
from typing import Tuple

import torch

from sdvo_tpu_torch.ops import build
from sdvo_tpu_torch.ops.window_sampler import sample_windows

BISECT_STEPS = 10

launches = 0
plain_cuda_calls = 0


def _bisect_median(x, vis, lo, hi, half_n):
    """Per-row masked median by range bisection; x, vis (N, P²), rest (N, 1)."""
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        cnt = torch.where(x <= mid, vis, torch.zeros_like(vis)).sum(1, keepdim=True)
        reach = cnt >= half_n
        lo = torch.where(reach, lo, mid)
        hi = torch.where(reach, mid, hi)
    return 0.5 * (lo + hi)


def _tukey_per_feature(r, vis, sigma_floor):
    big = torch.full((), 3.0e38, dtype=r.dtype, device=r.device)
    cnt = vis.sum(1, keepdim=True)
    half_n = 0.5 * torch.clamp(cnt, min=1.0)
    lo = torch.where(vis > 0.5, r, big).min(1, keepdim=True).values
    hi = torch.where(vis > 0.5, r, -big).max(1, keepdim=True).values
    lo = torch.where(cnt > 0.5, lo, torch.zeros_like(lo))
    hi = torch.where(cnt > 0.5, hi, torch.ones_like(hi))
    med = _bisect_median(r, vis, lo, hi, half_n)
    dev = torch.abs(r - med)
    hi2 = torch.where(vis > 0.5, dev, torch.zeros_like(dev)).max(1, keepdim=True).values
    mad = _bisect_median(dev, vis, torch.zeros_like(hi2), hi2, half_n)
    c = 4.6851 * torch.clamp(1.4826 * mad, min=sigma_floor)
    w = (1.0 - (r * r) / (c * c)) ** 2
    return torch.where(torch.abs(r) <= c, w, torch.zeros_like(w)) * vis


def _solve3(H, g, lam):
    a = H[0] + lam
    b, c = H[1], H[2]
    e = H[3] + lam
    f = H[4]
    i = H[5] + lam
    A = e * i - f * f
    B = -(b * i - f * c)
    C = b * f - e * c
    det = a * A + b * B + c * C
    bad = torch.abs(det) < 1e-12
    det_s = torch.where(bad, torch.ones_like(det), det)
    E = a * i - c * c
    F = -(a * f - b * c)
    I = a * e - b * b
    z = torch.zeros_like(det)
    return (torch.where(bad, z, (A * g[0] + B * g[1] + C * g[2]) / det_s),
            torch.where(bad, z, (B * g[0] + E * g[1] + F * g[2]) / det_s),
            torch.where(bad, z, (C * g[0] + F * g[1] + I * g[2]) / det_s))


def fa_align_batch_plain(windows, ref_patch, gx, gy, uv_init, origins, live, patch: int = 5,
                         max_iters: int = 10, sigma_floor: float = 1.0,
                         contrast_threshold: float = 1.0):
    """Plain PyTorch K2 (float32). Returns (uv (N, 2), rmse (N,), converged (N,))."""
    global plain_cuda_calls
    if windows.is_cuda:
        plain_cuda_calls += 1
    f32 = torch.float32
    win = windows.to(f32)
    refp = ref_patch.to(f32)
    gxf = gx.to(f32)
    gyf = gy.to(f32)
    u0 = uv_init[:, 0:1].to(f32)
    v0 = uv_init[:, 1:2].to(f32)
    ox = origins[:, 0:1].to(f32)
    oy = origins[:, 1:2].to(f32)
    livef = live.to(f32)[:, None]
    N, P2 = refp.shape

    def sample(u, v):
        vals, ok = sample_windows(win, torch.cat([u - ox, v - oy], 1), patch)
        return vals, ((livef > 0.5) & ok[:, None]).to(f32).expand(N, P2)

    def residuals(u, v, o):
        vals, vis = sample(u, v)
        return -(vals - refp + o) * vis, vis

    cur0, ok0f = sample(u0, v0)
    cnt0 = torch.clamp(ok0f.sum(1, keepdim=True), min=1.0)
    o0 = -((cur0 - refp) * ok0f).sum(1, keepdim=True) / cnt0
    r, vis = residuals(u0, v0, o0)
    chi = (r * r * _tukey_per_feature(r, vis, sigma_floor)).sum(1, keepdim=True)
    u, v, o = u0, v0, o0
    lam = torch.full((N, 1), 1e-2, dtype=f32, device=win.device)
    nu = torch.full((N, 1), 2.0, dtype=f32, device=win.device)
    stalled = 1.0 - livef
    for it in range(max_iters):
        w = _tukey_per_feature(r, vis, sigma_floor)
        rs = lambda x: x.sum(1, keepdim=True)  # noqa: E731
        H = (rs(w * gxf * gxf), rs(w * gxf * gyf), rs(w * gxf), rs(w * gyf * gyf), rs(w * gyf), rs(w))
        g = (rs(w * gxf * r), rs(w * gyf * r), rs(w * r))
        diag_max = torch.maximum(torch.abs(H[0]), torch.maximum(torch.abs(H[3]), torch.abs(H[5])))
        lam_eff = lam * diag_max if it == 0 else lam
        dx0, dx1, dx2 = _solve3(H, g, lam_eff)
        un, vn, on = u + dx0, v + dx1, o + dx2
        r_n, vis_n = residuals(un, vn, on)
        chi_n = (r_n * r_n * _tukey_per_feature(r_n, vis_n, sigma_floor)).sum(1, keepdim=True)
        pred = dx0 * (lam_eff * dx0 + g[0]) + dx1 * (lam_eff * dx1 + g[1]) + dx2 * (lam_eff * dx2 + g[2])
        rho = (chi - chi_n) / torch.clamp(pred, min=1e-30)
        success = (chi - chi_n) > 0.0
        lam = torch.where(success, lam_eff * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                          lam_eff * nu)
        nu = torch.where(success, torch.full_like(nu, 2.0), nu * 2.0)
        chi_ref = torch.clamp(chi, min=1e-30)
        rel_dec = (chi - chi_n) / chi_ref
        rel_pred = pred / chi_ref
        acc = success & (stalled < 0.5)
        u = torch.where(acc, un, u)
        v = torch.where(acc, vn, v)
        o = torch.where(acc, on, o)
        chi = torch.where(acc, chi_n, chi)
        r = torch.where(acc, r_n, r)
        vis = torch.where(acc, vis_n, vis)
        stalled = torch.maximum(stalled, ((success & (rel_dec < 1e-3)) | (rel_pred < 1e-4)).to(f32))
    cur_f, vis_f = sample(u, v)
    r_f = -(cur_f - refp + o) * vis_f
    n_vis = torch.clamp(vis_f.sum(1, keepdim=True), min=1.0)
    rmse = torch.sqrt((r_f * r_f).sum(1, keepdim=True) / n_vis)
    moved2 = (u - u0) ** 2 + (v - v0) ** 2
    mean_c = (cur_f * vis_f).sum(1, keepdim=True) / n_vis
    var_c = ((cur_f - mean_c) ** 2 * vis_f).sum(1, keepdim=True) / n_vis
    conv = (livef > 0.5) & (moved2 < (2.0 * patch) ** 2) & (var_c > contrast_threshold)
    dtype = uv_init.dtype
    return torch.cat([u, v], 1).to(dtype), rmse[:, 0].to(dtype), conv[:, 0]


def kernel_launcher(windows, ref_patch, gx, gy, uv_init, origins, live, patch: int = 5,
                    max_iters: int = 10, sigma_floor: float = 1.0,
                    contrast_threshold: float = 1.0):
    """Checks the inputs, allocates the outputs and returns (launch, uv (N, 2),
    rmse (N,), converged (N,) bool): ``launch()`` enqueues the kernel alone,
    on the current stream, and counts it. The kernel reads ``live`` as the
    bool tensor it is and writes ``converged`` as one, so float32 inputs cost
    no launch but the kernel's. Leading axes (S sequences of N features) are
    S·N rows of one launch."""
    dev = windows.device
    lead = tuple(windows.shape[:-3])
    N, WH, WW = windows.shape[-3:]
    P2 = patch * patch
    f32 = torch.float32
    uv0 = uv_init.to(f32).contiguous()
    live = live.to(torch.bool).contiguous()
    build.check_inputs(
        "fa_align_batch", dev,
        {k: lead + v for k, v in {"windows": (N, WH, WW), "ref_patch": (N, P2), "gx": (N, P2),
                                  "gy": (N, P2), "uv_init": (N, 2), "origins": (N, 2),
                                  "live": (N,)}.items()},
        dtypes={"live": torch.bool},
        windows=windows, ref_patch=ref_patch, gx=gx, gy=gy, uv_init=uv0, origins=origins,
        live=live,
    )
    uv = torch.empty(lead + (N, 2), dtype=f32, device=dev)
    rmse = torch.empty(lead + (N,), dtype=f32, device=dev)
    conv = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
    rows = live.numel()
    args = (windows.data_ptr(), ref_patch.data_ptr(), gx.data_ptr(), gy.data_ptr(), uv0.data_ptr(),
            origins.data_ptr(), live.data_ptr(), uv.data_ptr(), rmse.data_ptr(), conv.data_ptr(),
            rows, WH, WW, patch, max_iters, float(sigma_floor), float(contrast_threshold))
    launch = build.launcher(sys.modules[__name__], "fa_align_batch", "sdvo_fa_align", args, dev,
                            (uv0, live, windows, ref_patch, gx, gy, origins, uv, rmse, conv))
    return launch, uv, rmse, conv


def _op_cuda(*args):
    launch, uv, rmse, conv = kernel_launcher(*args)
    launch()
    return uv, rmse, conv


_op = build.define_op("fa_align_batch", "(Tensor windows, Tensor ref_patch, Tensor gx, Tensor gy, "
                      "Tensor uv_init, Tensor origins, Tensor live, int patch, int max_iters, "
                      "float sigma_floor, float contrast_threshold) -> (Tensor, Tensor, Tensor)",
                      fa_align_batch_plain, _op_cuda)


def fa_align_batch(windows, ref_patch, gx, gy, uv_init, origins, live, patch: int = 5,
                   max_iters: int = 10, sigma_floor: float = 1.0,
                   contrast_threshold: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Feature alignment of N features. windows (N, WH, WW) gradient windows,
    ref_patch/gx/gy (N, P²), uv_init/origins (N, 2), live (N,) bool.
    Returns (uv (N, 2), rmse (N,), converged (N,) bool)."""
    uv, rmse, conv = _op(windows, ref_patch, gx, gy, uv_init.to(torch.float32), origins,
                         live.to(torch.bool), int(patch), int(max_iters), float(sigma_floor),
                         float(contrast_threshold))
    dtype = uv_init.dtype
    return uv.to(dtype), rmse.to(dtype), conv
