"""Pinhole camera — from ``sdvo_tpu_torch.geometry.camera.PinholeCamera``.

The device path's point operations are those of the undistorted model;
``project``/``backproject`` take ``with_distortion`` for callers that want
the distorted model (``dist``, OpenCV order k1, k2, p1, p2, k3).
Intrinsics are Python floats holding the values of the compute dtype
(``create`` rounds them), so a float32 tensor op sees exactly the float32
intrinsics and a float64 op sees the same value widened.
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

    def K(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """(3, 3) intrinsic matrix."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
                            dtype=dtype, device=device)

    def invK(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """(3, 3) inverse of ``K``, written out as the reference does."""
        K = self.K(dtype, device)
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([torch.stack([1.0 / fx, z, -cx / fx]), torch.stack([z, 1.0 / fy, -cy / fy]),
                            torch.stack([z, z, o])])

    def distort_normalized(self, xy):
        """Apply the distortion on the normalized plane (..., 2) -> (..., 2);
        numpy arrays or tensors."""
        k1, k2, p1, p2, k3 = self.dist
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return _stack([xd, yd])

    def undistort_normalized(self, xy, iters: int = 8):
        """Invert the distortion by fixed-point iteration (as
        cv::undistortPoints); numpy arrays or tensors."""
        k1, k2, p1, p2, k3 = self.dist
        out = xy
        for _ in range(iters):
            x, y = out[..., 0], out[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            out = _stack([(xy[..., 0] - dx) / radial, (xy[..., 1] - dy) / radial])
        return out

    def project(self, pts_cam: torch.Tensor, with_distortion: bool = False) -> torch.Tensor:
        """Camera-frame 3D points (..., 3) -> pixel coords (..., 2)."""
        xy = pts_cam[..., :2] / pts_cam[..., 2:3]
        if with_distortion:
            xy = self.distort_normalized(xy)
        return torch.stack([self.fx * xy[..., 0] + self.cx, self.fy * xy[..., 1] + self.cy], dim=-1)

    def backproject(self, uv: torch.Tensor, with_distortion: bool = False) -> torch.Tensor:
        """Pixels (..., 2) -> unit bearing vectors (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        if with_distortion:
            xy = self.undistort_normalized(torch.stack([x, y], dim=-1))
            x, y = xy[..., 0], xy[..., 1]
        b = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        return b / torch.linalg.norm(b, dim=-1, keepdim=True)

    def normalized(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels -> normalized-plane homogeneous coords (..., 3) with z=1."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def is_in_frame(self, uv: torch.Tensor, boundary: float = 0.0, level: int = 0) -> torch.Tensor:
        """``uv`` (level-0 pixels) at least ``boundary`` px inside the image of
        pyramid level ``level``, which is ``2**level`` smaller."""
        scale = 1.0 / (2.0 ** level)
        w, h = self.width * scale, self.height * scale
        u, v = uv[..., 0] * scale, uv[..., 1] * scale
        return (u >= boundary) & (v >= boundary) & (u < w - boundary) & (v < h - boundary)

    def scaled(self, level: int) -> "PinholeCamera":
        """The intrinsics at pyramid level ``level`` (coordinates / 2**level)."""
        s = 1.0 / (2.0 ** level)
        return PinholeCamera(self.fx * s, self.fy * s, self.cx * s, self.cy * s,
                             self.width >> level, self.height >> level, self.dist)


