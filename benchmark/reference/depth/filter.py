"""Mixed Gaussian-Beta (Vogiatzis) inverse-depth filters, batched — port of
``sdvo_tpu.depth.filter`` (``FilterBank``, ``init_filters``, ``compute_tau``,
``vogiatzis_update``, ``update_filters``)."""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from benchmark.reference.depth.epipolar import epipolar_search
from benchmark.reference.geometry.robust import gaussian_pdf
from benchmark.reference.geometry.se3 import SE3


class FilterBank(NamedTuple):
    """Fixed-capacity (C,) SoA of depth filters."""

    uv_ref: torch.Tensor  # (C, 2) pixel in the host keyframe
    bearing_ref: torch.Tensor  # (C, 3) unit bearing in the host keyframe
    ref_patch: torch.Tensor  # (C, P²)
    kf_slot: torch.Tensor  # (C,) int32 host keyframe slot
    mu: torch.Tensor  # (C,) inverse-depth mean
    var: torch.Tensor  # (C,) inverse-depth variance
    a: torch.Tensor  # (C,) Beta inlier count
    b: torch.Tensor  # (C,) Beta outlier count
    max_inv_depth: torch.Tensor  # (C,) 1/depth_min
    born_kf: torch.Tensor  # (C,) int32 keyframe counter at creation
    valid: torch.Tensor  # (C,) bool

    @staticmethod
    def empty(capacity: int, patch_area: int, dtype=torch.float32, device=None) -> "FilterBank":
        C = capacity
        kw = dict(dtype=dtype, device=device)
        bearing = torch.zeros((C, 3), **kw)
        bearing[:, 2] = 1.0
        return FilterBank(
            uv_ref=torch.zeros((C, 2), **kw), bearing_ref=bearing,
            ref_patch=torch.zeros((C, patch_area), **kw),
            kf_slot=torch.zeros((C,), dtype=torch.int32, device=device),
            mu=torch.ones((C,), **kw), var=torch.ones((C,), **kw),
            a=torch.full((C,), 10.0, **kw), b=torch.full((C,), 10.0, **kw),
            max_inv_depth=torch.ones((C,), **kw),
            born_kf=torch.zeros((C,), dtype=torch.int32, device=device),
            valid=torch.zeros((C,), dtype=torch.bool, device=device),
        )


def init_filters(uv, bearing, ref_patch, kf_slot, depth_mean, depth_min, kf_counter, new_valid,
                 dtype=torch.float32) -> FilterBank:
    """Seeds: Beta(10, 10), mu = 1/depth_mean, max_inv_depth = 1/depth_min,
    sigma = max_inv_depth/6. ``kf_slot``/``kf_counter`` are ints or 0-d
    int tensors; ``depth_mean``/``depth_min`` floats or 0-d tensors."""
    N = uv.shape[0]
    dev = uv.device
    depth_mean = torch.as_tensor(depth_mean, dtype=dtype, device=dev)
    depth_min = torch.as_tensor(depth_min, dtype=dtype, device=dev)
    mu = torch.ones((N,), dtype=dtype, device=dev) / torch.clamp(depth_mean, min=1e-9)
    max_inv = torch.ones((N,), dtype=dtype, device=dev) / torch.clamp(depth_min, min=1e-9)
    sigma = max_inv / 6.0
    i32 = dict(dtype=torch.int32, device=dev)
    return FilterBank(
        uv_ref=uv.to(dtype), bearing_ref=bearing.to(dtype), ref_patch=ref_patch.to(dtype),
        kf_slot=torch.as_tensor(kf_slot, **i32).expand(N).clone(),
        mu=mu, var=sigma * sigma,
        a=torch.full((N,), 10.0, dtype=dtype, device=dev),
        b=torch.full((N,), 10.0, dtype=dtype, device=dev),
        max_inv_depth=max_inv,
        born_kf=torch.as_tensor(kf_counter, **i32).expand(N).clone(),
        valid=new_valid,
    )


def compute_tau(T_cur_ref: SE3, bearing, depth, px_error_angle: float):
    """Depth uncertainty from a one-pixel angular error (law of sines)."""
    t = T_cur_ref.translation.expand(bearing.shape)
    a = bearing * depth[..., None] - t
    t_norm = torch.linalg.norm(t, dim=-1)
    a_norm = torch.linalg.norm(a, dim=-1)
    alpha = torch.arccos(torch.clamp(torch.sum(bearing * t, dim=-1) / torch.clamp(t_norm, min=1e-12),
                                     -1.0, 1.0))
    beta = torch.arccos(torch.clamp(torch.sum(a * -t, dim=-1) / torch.clamp(t_norm * a_norm, min=1e-12),
                                    -1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma = math.pi - alpha - beta_plus
    gamma = torch.where(torch.abs(torch.sin(gamma)) < 1e-9, torch.full_like(gamma, 1e-9), gamma)
    return t_norm * torch.sin(beta_plus) / torch.sin(gamma) - depth


def vogiatzis_update(mu, var, a, b, x, tau2, max_inv_depth):
    """Closed-form Gaussian×Beta posterior (inverse-depth units)."""
    norm_scale = torch.clamp(torch.sqrt(var + tau2), min=1e-12)
    var_s = torch.clamp(var, min=1e-18)
    tau2_s = torch.clamp(tau2, min=1e-18)
    s2 = 1.0 / (1.0 / var_s + 1.0 / tau2_s)
    m = s2 * (mu / var_s + x / tau2_s)
    C1 = a / (a + b) * gaussian_pdf(mu, norm_scale, x)
    C2 = b / (a + b) * (1.0 / torch.clamp(max_inv_depth, min=1e-12))
    norm_const = torch.clamp(C1 + C2, min=1e-300 if mu.dtype == torch.float64 else 1e-30)
    C1 = C1 / norm_const
    C2 = C2 / norm_const
    f = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e = C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0)) + C2 * a * (a + 1.0) / (
        (a + b + 1.0) * (a + b + 2.0))
    mu_new = C1 * m + C2 * mu
    var_new = C1 * (s2 + m * m) + C2 * (var + mu * mu) - mu_new * mu_new
    f_s = torch.clamp(f, min=1e-12)
    denom = f - e / f_s
    denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    a_new = (e - f) / denom
    b_new = a_new * (1.0 - f) / f_s
    return mu_new, torch.clamp(var_new, min=1e-18), a_new, b_new


@functools.lru_cache(maxsize=64)
def _px_error_angle(fx: float, dtype: torch.dtype) -> float:
    """The angle one pixel subtends, 2·atan(1 / 2fx), rounded as the
    reference rounds it (in ``dtype``); a host constant, computed once a
    focal length."""
    return float(torch.arctan(torch.tensor(1.0 / (2.0 * fx), dtype=dtype))) * 2.0


def update_filters(bank: FilterBank, T_cur_kf: SE3, cur_image, fx, fy, cx, cy, kf_counter,
                   patch_size: int = 7, num_steps: int = 16, staleness: int = 5,
                   convergence_factor: float = 10.0) -> Tuple[FilterBank, torch.Tensor]:
    """One batched filter-bank update; returns (bank', converged (C,))."""
    dtype = bank.mu.dtype
    valid = bank.valid & ((kf_counter - bank.born_kf) <= staleness)
    sigma = torch.sqrt(bank.var)
    inv_min = bank.mu + sigma
    inv_max = torch.clamp(bank.mu - sigma, min=1e-7)
    depth, matched, _ = epipolar_search(
        T_cur_kf, cur_image, bank.ref_patch, bank.bearing_ref, bank.mu, inv_min, inv_max, valid,
        fx, fy, cx, cy, patch_size=patch_size, num_steps=num_steps,
    )
    px_error_angle = _px_error_angle(fx, dtype)
    tau = compute_tau(T_cur_kf, bank.bearing_ref, depth, px_error_angle)
    d_minus = torch.clamp(depth - tau, min=1e-7)
    inv_tau = 0.5 * (1.0 / d_minus - 1.0 / (depth + tau))
    x = 1.0 / torch.clamp(depth, min=1e-9)
    mu_n, var_n, a_n, b_n = vogiatzis_update(bank.mu, bank.var, bank.a, bank.b, x,
                                             inv_tau * inv_tau, bank.max_inv_depth)
    upd = valid & matched
    mu_out = torch.where(upd, mu_n, bank.mu)
    var_out = torch.where(upd, var_n, bank.var)
    a_out = torch.where(upd, a_n, bank.a)
    b_out = torch.where(upd, b_n, torch.where(valid & ~matched, bank.b + 1.0, bank.b))
    converged = upd & (torch.sqrt(var_out) * convergence_factor < bank.max_inv_depth)
    finite = torch.isfinite(mu_out) & torch.isfinite(var_out)
    bank_out = bank._replace(mu=mu_out.to(dtype), var=var_out.to(dtype), a=a_out.to(dtype),
                             b=b_out.to(dtype), valid=valid & finite & ~converged)
    return bank_out, converged
