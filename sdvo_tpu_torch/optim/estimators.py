"""M-estimator weight functions over masked residual tensors — port of
``sdvo_tpu.optim.estimators`` (the 15 robust weight functions with their
MAD-based sigma, and the Barron general robust loss). Each maps residuals
(N,) + valid mask (N,) → IRLS weights (N,); masked entries get weight 0.

The tuning constants (1.345σ Huber, 4.6851σ Tukey, …) match the reference,
which takes them from "Parameter Estimation Techniques: A Tutorial with
Application to Conic Fitting" (Zhang).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from sdvo_tpu_torch.geometry.robust import masked_median

_EPS = 1e-12


def compute_std(residuals: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Robust sigma: 1.4826 * (1 + 5/(n-6)) * median(|r|)
    (``Estimator::computeSTD``, src/estimator.cpp:107-119)."""
    if mask is None:
        mask = torch.ones_like(residuals, dtype=torch.bool)
    med = masked_median(torch.abs(residuals), mask)
    n = torch.clamp(mask.to(residuals.dtype).sum(), min=7.0)  # guard the reference's n-6 pole
    return 1.4826 * (1.0 + 5.0 / (n - 6.0)) * med


def _sigma_floor(sigma: torch.Tensor) -> torch.Tensor:
    return torch.clamp(sigma, min=_EPS)


def _l2(r, sigma):
    return torch.ones_like(r)


def _l1(r, sigma):
    return 1.0 / torch.clamp(torch.abs(r), min=_EPS)


def _l1l2(r, sigma):  # "diff" in the reference registry
    return 1.0 / torch.sqrt(1.0 + r * r / 2.0)


def _lp(r, sigma, p: float = 1.2):
    return 1.0 / torch.clamp(torch.abs(r), min=_EPS) ** p


def _fair(r, sigma):
    c = 1.3998 * sigma
    return 1.0 / (1.0 + torch.abs(r) / c)


def _huber(r, sigma):
    c = 1.345 * sigma
    a = torch.abs(r)
    return torch.where(a <= c, torch.ones_like(a), c / torch.clamp(a, min=_EPS))


def _cauchy(r, sigma):
    c = 2.3849 * sigma
    return 1.0 / (1.0 + (r * r) / (c * c))


def _geman_mcclure(r, sigma):
    return 1.0 / (1.0 + r * r) ** 2


def _welch(r, sigma):
    c = 2.9846 * sigma
    return torch.exp(-(r * r) / (c * c))


def _tukey(r, sigma):
    c = 4.6851 * sigma
    a = torch.abs(r)
    w = (1.0 - (r * r) / (c * c)) ** 2
    return torch.where(a <= c, w, torch.zeros_like(w))


def _drummond(r, sigma):
    return 1.0 / torch.clamp(torch.abs(r + sigma), min=_EPS)


def _andrew_wave(r, sigma):
    c = 1.3387 * sigma
    a = torch.abs(r)
    x = r / c
    x_safe = torch.where(torch.abs(x) < _EPS, torch.ones_like(x), x)
    w = torch.where(torch.abs(x) < _EPS, torch.ones_like(x), torch.sin(x_safe) / x_safe)
    return torch.where(a <= c * math.pi, w, torch.zeros_like(w))


def _ramsay(r, sigma):
    return torch.exp(-(r * sigma))


def _trimmed_mean(r, sigma):
    return (torch.abs(r) <= sigma).to(r.dtype)


def _t_distribution(r, sigma):
    return 6.0 / (5.0 + (r * r) / (sigma * sigma))


MESTIMATORS: Dict[str, Callable] = {
    # same registry keys as the reference's ``allMethods`` (src/estimator.cpp:8-23)
    "l2": _l2,
    "l1": _l1,
    "diff": _l1l2,
    "lp": _lp,
    "fair": _fair,
    "huber": _huber,
    "cauchy": _cauchy,
    "geman-mcclure": _geman_mcclure,
    "welch": _welch,
    "tukey": _tukey,
    "drummond": _drummond,
    "andrew-wave": _andrew_wave,
    "ramsay": _ramsay,
    "trimmed-mean": _trimmed_mean,
    "t-distro": _t_distribution,
}


def mestimator_weights(
    residuals: torch.Tensor, method: str = "tukey", mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Dispatch table entry point (``Estimator::MEstimator``)."""
    if method not in MESTIMATORS:
        raise KeyError(f"unknown M-estimator '{method}'; known: {sorted(MESTIMATORS)}")
    if mask is None:
        mask = torch.ones_like(residuals, dtype=torch.bool)
    sigma = _sigma_floor(compute_std(residuals, mask))
    w = MESTIMATORS[method](residuals, sigma)
    return torch.where(mask, w, torch.zeros_like(w))


def barron_weights(residuals: torch.Tensor, alpha: float, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Barron's general robust loss IRLS weights
    (``Estimator::computeGeneralFunctionBarron``, src/estimator.cpp:313-333)."""
    if mask is None:
        mask = torch.ones_like(residuals, dtype=torch.bool)
    c = _sigma_floor(compute_std(residuals, mask))
    r2c2 = residuals * residuals / (c * c)
    if alpha == 0.0:
        w = 2.0 / (residuals * residuals + 2.0 * c * c)
    elif alpha == -math.inf:
        w = (1.0 / (c * c)) * torch.exp(-0.5 * r2c2)
    else:
        z = max(1.0, 2.0 - alpha)
        w = (1.0 / (c * c)) * (r2c2 / z + 1.0) ** (alpha / 2.0 - 1.0)
    return torch.where(mask, w, torch.zeros_like(w))
