"""Pinhole camera — port of ``sdvo_tpu.geometry.camera.PinholeCamera``.

The point operations are those of the undistorted model: a camera with
distortion (``dist``, OpenCV order k1, k2, p1, p2, k3) is handled at ingest,
where ``System.preprocess_image`` remaps every image through
``build_undistort_maps`` so that the pipeline runs on the pinhole model.
Intrinsics are Python floats holding the values of the compute dtype
(``create`` rounds them), so a float32 tensor op sees exactly the float32
intrinsics the JAX reference uses and a float64 op sees the same value
widened, as JAX's type promotion does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    dist: Tuple[float, ...] = (0.0,) * 5  # zeros disable distortion

    @staticmethod
    def create(fx, fy, cx, cy, width, height, dist=None, dtype=torch.float32) -> "PinholeCamera":
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        r = lambda v: float(np_dtype(v))  # noqa: E731
        d = (0.0,) * 5 if dist is None else tuple(r(v) for v in np.asarray(dist).reshape(-1))
        return PinholeCamera(r(fx), r(fy), r(cx), r(cy), int(width), int(height), d)

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 1e-12 for v in self.dist)

    def distort_normalized(self, xy: np.ndarray) -> np.ndarray:
        """Apply the distortion on the normalized plane (..., 2) -> (..., 2)."""
        k1, k2, p1, p2, k3 = self.dist
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return np.stack([xd, yd], axis=-1)

    def project(self, pts_cam: torch.Tensor) -> torch.Tensor:
        """Camera-frame 3D points (..., 3) -> pixel coords (..., 2)."""
        xy = pts_cam[..., :2] / pts_cam[..., 2:3]
        return torch.stack([self.fx * xy[..., 0] + self.cx, self.fy * xy[..., 1] + self.cy], dim=-1)

    def backproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> unit bearing vectors (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        b = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        return b / torch.linalg.norm(b, dim=-1, keepdim=True)

    def normalized(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels -> normalized-plane homogeneous coords (..., 3) with z=1."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def build_undistort_maps(cam: PinholeCamera) -> Tuple[np.ndarray, np.ndarray]:
    """Remap grids (map_u, map_v), each (H, W) float64, from an undistorted
    pixel to its source pixel in the distorted image (numpy, on the host)."""
    H, W = cam.height, cam.width
    vv, uu = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    xy = np.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy], axis=-1)
    xyd = cam.distort_normalized(xy)
    return cam.fx * xyd[..., 0] + cam.cx, cam.fy * xyd[..., 1] + cam.cy
