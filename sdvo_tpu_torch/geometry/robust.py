"""Robust statistics — port of the parts of ``sdvo_tpu.geometry.robust`` the
port's path uses: ``masked_median`` (KLT disparity gate) and ``gaussian_pdf``
(the Vogiatzis update)."""

from __future__ import annotations

import math

import torch


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of valid entries (index count//2 of the sorted valid values, as
    the reference); +inf when nothing is valid."""
    x = x.reshape(-1)
    mask = mask.reshape(-1)
    s = torch.sort(torch.where(mask, x, torch.full_like(x, math.inf))).values
    idx = torch.clamp(mask.to(torch.int64).sum() // 2, max=x.shape[0] - 1)
    return s[idx]


def gaussian_pdf(mean: torch.Tensor, sigma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Normal density (``sdvo_tpu.geometry.robust.gaussian_pdf``)."""
    z = (x - mean) / sigma
    inv = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
    return inv * torch.exp(-0.5 * z * z)
