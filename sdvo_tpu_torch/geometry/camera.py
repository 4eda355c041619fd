"""Pinhole camera — port of ``sdvo_tpu.geometry.camera.PinholeCamera``.

Only the undistorted model: the port's inputs (rectified KITTI frames and the
synthetic scenes) carry no distortion, so the undistortion maps are not
ported. Intrinsics are Python floats holding the values of the compute dtype
(``create`` rounds them), so a float32 tensor op sees exactly the float32
intrinsics the JAX reference uses and a float64 op sees the same value
widened, as JAX's type promotion does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, width, height, dtype=torch.float32) -> "PinholeCamera":
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        r = lambda v: float(np_dtype(v))  # noqa: E731
        return PinholeCamera(r(fx), r(fy), r(cx), r(cy), int(width), int(height))

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
