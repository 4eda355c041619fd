"""Feature detection — port of ``sdvo_tpu.features.detection``:
``detect_gradient_by_value`` (device max-per-cell detector of the keyframe
step) and ``FeatureSelection.detect_with_ssc`` (threshold → SSC ANMS → grid
bucketing on the host, used by the bootstrap)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sdvo_tpu_torch.features import ssc as ssc_mod


class DetectedFeatures(NamedTuple):
    uv: np.ndarray  # (K, 2) float32 pixel positions
    response: np.ndarray  # (K,)


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


class FeatureSelection:
    """Owns the occupancy grid of the SSC keyframe detector."""

    def __init__(self, width: int, height: int, cell_size: int):
        self.cell_size = int(cell_size)
        self.grid_cols = int(np.ceil(width / cell_size))
        self.grid_rows = int(np.ceil(height / cell_size))
        self.occupancy = np.zeros((self.grid_rows, self.grid_cols), dtype=np.uint8)

    def reset_grid(self):
        self.occupancy[:] = 0

    def set_existing_features(self, uv: np.ndarray):
        """Mark the cells of existing features occupied."""
        if len(uv) == 0:
            return
        cx = (np.asarray(uv)[:, 0] // self.cell_size).astype(int)
        cy = (np.asarray(uv)[:, 1] // self.cell_size).astype(int)
        ok = (cx >= 0) & (cy >= 0) & (cx < self.grid_cols) & (cy < self.grid_rows)
        self.occupancy[cy[ok], cx[ok]] = 1

    def detect_with_ssc(self, gradient_image: np.ndarray, threshold: int, num_candidates: int,
                        tolerance: float = 0.1) -> DetectedFeatures:
        grad = np.asarray(gradient_image)
        rows, cols = grad.shape
        xs, ys, resp = ssc_mod.threshold_extract(grad, threshold)
        if xs.shape[0] == 0:
            return DetectedFeatures(np.empty((0, 2), np.float32), np.empty(0, np.float32))
        sel = ssc_mod.ssc_select(xs, ys, num_candidates, tolerance, cols, rows)
        xs, ys, resp = xs[sel], ys[sel], resp[sel]
        self.occupancy, keep = ssc_mod.bucket_points(xs, ys, self.cell_size, self.grid_cols,
                                                     self.grid_rows, self.occupancy)
        return DetectedFeatures(np.stack([xs[keep], ys[keep]], axis=-1), resp[keep])
