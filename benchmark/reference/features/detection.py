"""Feature detection — from ``sdvo_tpu_torch.features.detection``:
``detect_gradient_by_value``, the keyframe step's max-per-cell detector."""

from __future__ import annotations

from typing import Optional

import torch


def detect_gradient_by_value(gradient_image: torch.Tensor, threshold: float, cell_size: int,
                             occupied: Optional[torch.Tensor] = None):
    """One candidate per full grid cell: its strongest pixel. Returns
    (uv (C, 2), response (C,), valid (C,)), C = (H//cell)·(W//cell)."""
    H, W = gradient_image.shape
    gr, gc = H // cell_size, W // cell_size
    img = gradient_image[: gr * cell_size, : gc * cell_size]
    cells = img.reshape(gr, cell_size, gc, cell_size).permute(0, 2, 1, 3).reshape(gr, gc, -1)
    resp, best = torch.max(cells, dim=-1)
    by = torch.div(best, cell_size, rounding_mode="floor")
    bx = best % cell_size
    dev = gradient_image.device
    cy = torch.arange(gr, device=dev)[:, None] * cell_size
    cx = torch.arange(gc, device=dev)[None, :] * cell_size
    uv = torch.stack([(cx + bx).to(img.dtype), (cy + by).to(img.dtype)], dim=-1)
    valid = resp > threshold
    if occupied is not None:
        valid = valid & ~occupied[:gr, :gc]
    return uv.reshape(-1, 2), resp.reshape(-1), valid.reshape(-1)
