"""The LM pieces the device path reads — from
``sdvo_tpu_torch.optim.optimizer``: ``LMSettings``, ``OptimizerStatus``,
the robust weights (``tukey_weights``, ``robust_sigma``, ``_weights_for``),
``_chi2``, ``tree_where`` and the diagnostics sink that
``LMSettings.visualize`` feeds (residuals, weights, visibility and JᵀWJ at
the final iterate, as numpy arrays, to the sink installed with
``set_diagnostics_sink``).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from benchmark.reference.geometry.robust import masked_mad, masked_mad_hist

# the sink of the post-solve diagnostics, fn(tag, residuals, weights,
# visible, H) on numpy arrays, or None (set_diagnostics_sink)
_DIAGNOSTICS_SINK = None


class LevenbergMethod(enum.Enum):
    MARQUARDT = "marquardt"  # H += lambda * diag(H); lambda /9 or *11
    QUADRATIC = "quadratic"  # line-fit damping: alpha rescales the accepted step
    NIELSEN = "nielsen"  # H += lambda * I; Nielsen's nu schedule


class OptimizerStatus:
    SUCCESS = 0
    NON_SUFF_POINTS = 1
    MAX_COFF_DX = 2
    NON_FINITE_DX = 3
    SMALL_STEP = 4
    LAMBDA_BOUND = 5
    FAILED = 6


class LMSettings(NamedTuple):
    max_iterations: int = 20
    min_chi2: float = 1e-1
    min_step: float = 1e-16
    max_dx: float = 1e3
    init_lambda: float = 1e-2
    lambda_min: float = 1e-14
    lambda_max: float = 1e14
    method: str = "nielsen"
    estimator: str = "tukey"  # any key of estimators.MESTIMATORS
    mad: str = "exact"  # "exact": sort-based MAD; "hist": histogram-CDF MAD
    min_rel_decrease: float = 0.0  # 0 = run to max_iterations
    freeze_sigma: bool = False  # robust scale once, from the initial residuals
    visualize: bool = False  # emit post-solve diagnostics to the sink (set_diagnostics_sink)
    viz_tag: str = ""


def set_diagnostics_sink(fn) -> None:
    """Install fn(tag, residuals, weights, visible, H) — numpy arrays — or None."""
    global _DIAGNOSTICS_SINK
    _DIAGNOSTICS_SINK = fn


def _dispatch_diagnostics(tag: str, r, w, vis, H) -> None:
    """Hand one solve's diagnostics to the sink, as numpy arrays."""
    if _DIAGNOSTICS_SINK is not None:
        _DIAGNOSTICS_SINK(tag, *(x.detach().cpu().numpy() for x in (r, w, vis, H)))


def tukey_weights(residuals: torch.Tensor, visible: torch.Tensor, mad: str = "exact",
                  sigma=None) -> torch.Tensor:
    """sigma = 1.4826·MAD over visible residuals, c = 4.6851σ, zero outside."""
    if sigma is None:
        sigma = robust_sigma(residuals, visible, mad)
    sigma = torch.clamp(sigma, min=torch.finfo(residuals.dtype).eps)
    c = 4.6851 * sigma
    w = (1.0 - (residuals * residuals) / (c * c)) ** 2
    w = torch.where(torch.abs(residuals) <= c, w, torch.zeros_like(w))
    return torch.where(visible, w, torch.zeros_like(w))


def robust_sigma(residuals: torch.Tensor, visible: torch.Tensor, mad: str = "exact") -> torch.Tensor:
    mad_fn = masked_mad_hist if mad == "hist" else masked_mad
    return 1.4826 * mad_fn(residuals, visible)


def _weights_for(estimator: str, residuals, visible, mad: str = "exact", sigma=None):
    if estimator == "tukey":
        return tukey_weights(residuals, visible, mad, sigma)
    from benchmark.reference.optim.estimators import mestimator_weights

    return mestimator_weights(residuals, estimator, visible)


def _chi2(residuals, weights, visible):
    r2 = residuals * residuals * weights
    return torch.where(visible, r2, torch.zeros_like(r2)).sum()


_UNROLL_MAX_D = 8


def tree_where(cond: torch.Tensor, a, b):
    """``torch.where(cond, a, b)`` over matching nested tuples / NamedTuples
    of tensors; a leaf that is no tensor is taken from ``a``."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(a, tuple):
        vals = [tree_where(cond, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return a


