"""Robust statistics — port of ``sdvo_tpu.geometry.robust``:
``masked_median``, ``masked_mad`` and ``masked_mad_hist`` (the robust scale of ``optim.optimizer``) and
``gaussian_pdf`` (the Vogiatzis update)."""

from __future__ import annotations

import math
from typing import Optional

import torch

MAD_SCALE = 1.4826


def masked_median(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Median of valid entries (index count//2 of the sorted valid values, as
    the reference); +inf when nothing is valid."""
    x = x.reshape(-1)
    if mask is None:
        return torch.sort(x).values[x.shape[0] // 2]
    mask = mask.reshape(-1)
    s = torch.sort(torch.where(mask, x, torch.full_like(x, math.inf))).values
    idx = torch.clamp(mask.to(torch.int64).sum() // 2, max=x.shape[0] - 1)
    return s[idx]


def masked_mad(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Median absolute deviation of the valid entries."""
    med = masked_median(x, mask)
    return masked_median(torch.abs(x.reshape(-1) - med), mask)


def _hist_median(x, mask, lo, hi, bins: int) -> torch.Tensor:
    """Masked median from a histogram's cumulative counts, interpolated
    inside the bin that reaches half of the count."""
    dtype = x.dtype
    binw = torch.clamp(hi - lo, min=1e-12) / bins
    b = torch.clamp(((x - lo) / binw).to(torch.int32), 0, bins - 1).to(torch.int64)
    counts = torch.zeros((bins,), dtype=dtype, device=x.device).index_add(0, b, mask.to(dtype))
    cdf = torch.cumsum(counts, 0)
    target = 0.5 * counts.sum()
    k = torch.argmax((cdf >= target).to(torch.int32))  # first bin whose cdf reaches the median
    nk = torch.clamp(counts[k], min=1.0)
    frac = (target - (cdf[k] - counts[k])) / nk
    return lo + (k.to(dtype) + frac) * binw


def masked_mad_hist(x: torch.Tensor, mask: Optional[torch.Tensor] = None, bins: int = 256) -> torch.Tensor:
    """Histogram-approximate MAD: two histogram passes (median, then median
    of the absolute deviations) over the range of the valid entries; +inf
    when nothing is valid."""
    x = x.reshape(-1)
    mask = torch.ones_like(x, dtype=torch.bool) if mask is None else mask.reshape(-1)
    inf = torch.full_like(x, math.inf)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    xz = torch.where(mask, x, torch.zeros_like(x))
    empty = ~mask.any()
    lo = torch.where(empty, zero, torch.where(mask, x, inf).min())
    hi = torch.where(empty, one, torch.where(mask, x, -inf).max())
    med = _hist_median(xz, mask, lo, hi, bins)
    dev = torch.abs(xz - med)
    hi2 = torch.where(empty, one, torch.where(mask, dev, -inf).max())
    mad = _hist_median(dev, mask, zero, hi2, bins)
    return torch.where(empty, torch.full_like(mad, math.inf), mad)


def gaussian_pdf(mean: torch.Tensor, sigma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Normal density (``sdvo_tpu.geometry.robust.gaussian_pdf``)."""
    z = (x - mean) / sigma
    inv = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
    return inv * torch.exp(-0.5 * z * z)
