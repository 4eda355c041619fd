"""Feature detection — port of ``sdvo_tpu.features.detection``:
``detect_gradient_by_value`` (device max-per-cell detector of the keyframe
step), ``gradient_magnitude_with_ssc`` (threshold → SSC ANMS → grid
bucketing on the host, used by the bootstrap through
``FeatureSelection.detect_with_ssc``), ``gradient_orientation`` and
``FeatureType``."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sdvo_tpu_torch.features import ssc as ssc_mod


class FeatureType:
    """The reference's feature types."""

    CORNER = 0
    EDGE = 1
    DEFAULT = 2


class DetectedFeatures(NamedTuple):
    uv: np.ndarray  # (K, 2) float32 pixel positions
    response: np.ndarray  # (K,)
    angle: np.ndarray = None  # (K,) gradient orientation (radians)
    ftype: np.ndarray = None  # (K,) int FeatureType


def gradient_orientation(image: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """atan2(dy, dx) of central differences at the integer feature pixels
    (clipped one pixel inside the image)."""
    if len(uv) == 0:
        return np.zeros((0,), np.float32)
    img = np.asarray(image, np.float32)
    H, W = img.shape
    x = np.clip(np.asarray(uv)[:, 0].astype(int), 1, W - 2)
    y = np.clip(np.asarray(uv)[:, 1].astype(int), 1, H - 2)
    gx = 0.5 * (img[y, x + 1] - img[y, x - 1])
    gy = 0.5 * (img[y + 1, x] - img[y - 1, x])
    return np.arctan2(gy, gx).astype(np.float32)


def gradient_magnitude_with_ssc(gradient_image: np.ndarray, detection_threshold: int, num_candidates: int,
                                cell_size: int, occupancy: Optional[np.ndarray] = None, tolerance: float = 0.1,
                                use_bucketing: bool = True) -> Tuple[DetectedFeatures, np.ndarray]:
    """The keyframe detector: pixels above the threshold, strongest first,
    thinned by SSC to about ``num_candidates``, then one a free grid cell of
    ``occupancy`` (grid_rows, grid_cols) uint8, whose occupied cells are
    skipped. Detections are CORNERs with the orientation of the magnitude
    surface. Returns (features, occupancy)."""
    grad = np.asarray(gradient_image)
    rows, cols = grad.shape
    grid_cols = int(np.ceil(cols / cell_size))
    grid_rows = int(np.ceil(rows / cell_size))
    if occupancy is None:
        occupancy = np.zeros((grid_rows, grid_cols), dtype=np.uint8)
    xs, ys, resp = ssc_mod.threshold_extract(grad, detection_threshold)
    if xs.shape[0] == 0:
        empty = np.empty(0, np.float32)
        return DetectedFeatures(np.empty((0, 2), np.float32), empty, empty, np.empty(0, np.int32)), occupancy
    sel = ssc_mod.ssc_select(xs, ys, num_candidates, tolerance, cols, rows)
    xs, ys, resp = xs[sel], ys[sel], resp[sel]
    if use_bucketing:
        occupancy, keep = ssc_mod.bucket_points(xs, ys, cell_size, grid_cols, grid_rows, occupancy)
        xs, ys, resp = xs[keep], ys[keep], resp[keep]
    uv = np.stack([xs, ys], axis=-1)
    return DetectedFeatures(uv, resp, gradient_orientation(grad, uv),
                            np.full(len(uv), FeatureType.CORNER, np.int32)), occupancy


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
    """Owns the occupancy grid of the detectors."""

    def __init__(self, width: int, height: int, cell_size: int):
        self.width = int(width)
        self.height = int(height)
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
        feats, self.occupancy = gradient_magnitude_with_ssc(gradient_image, threshold, num_candidates,
                                                            self.cell_size, self.occupancy, tolerance)
        return feats

    def detect_by_value(self, gradient_image: torch.Tensor, threshold: float):
        """``detect_gradient_by_value`` with the occupied cells skipped."""
        occ = torch.as_tensor(self.occupancy.astype(bool), device=gradient_image.device)
        return detect_gradient_by_value(gradient_image, threshold, self.cell_size, occ)
