"""Sparse photometric image alignment against precomputed reference tables —
port of the device path of ``sdvo_tpu.align.image_alignment.SparseImageAlign``:
``precompute_ref_windows`` (keyframe cadence), ``align_precomputed`` (every
frame, its kernel branch), ``_project_level`` and ``_jac_rows``.

Pure inverse-compositional, as the JAX precomputed path (it ignores
``use_esm``). Each level runs K1 (``sdvo_tpu_torch.ops.lm_align``) with the
Pallas path's iteration taper ``max(4, max_iterations − taper·(max_level −
level))``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.ops.lm_align import lm_align_level
from sdvo_tpu_torch.ops.window_sampler import sample_windows_grad, window_gather


class AlignFeatures(NamedTuple):
    """Fixed-capacity SoA batch of alignment features (leading dim N)."""

    uv_host: torch.Tensor  # (N, 2) level-0 pixel position in the host image
    host_idx: torch.Tensor  # (N,) int32 host index (0 on the device path)
    points_ref: torch.Tensor  # (N, 3) point in the reference camera frame
    valid: torch.Tensor  # (N,) bool


class SparseImageAlign:
    """Coarse-to-fine sparse alignment over precomputed reference tables."""

    def __init__(self, patch_size: int = 5, min_level: int = 0, max_level: int = 3,
                 max_iterations: int = 10, min_rel_decrease: float = 2e-3,
                 window: int = 16, level_taper: int = 2):
        self.patch_size = int(patch_size)
        self.min_level = int(min_level)
        self.max_level = int(max_level)
        self.max_iterations = int(max_iterations)
        self.min_rel_decrease = float(min_rel_decrease)
        self.window = int(window)
        self.level_taper = int(level_taper)

    def level_iterations(self, level: int) -> int:
        return max(4, self.max_iterations - self.level_taper * (self.max_level - level))

    def _jac_rows(self, feats: AlignFeatures, fx: float, fy: float, level: int):
        scale = 1.0 / (1 << level)
        p = feats.points_ref
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.ones_like(z), z)
        iz2 = iz * iz
        fxs = fx * scale
        fys = fy * scale
        zero = torch.zeros_like(x)
        row_u = torch.stack([fxs * iz, zero, -fxs * x * iz2, -fxs * x * y * iz2,
                             fxs * (1.0 + x * x * iz2), -fxs * y * iz], -1)
        row_v = torch.stack([zero, fys * iz, -fys * y * iz2, -fys * (1.0 + y * y * iz2),
                             fys * x * y * iz2, fys * x * iz], -1)
        return row_u, row_v

    def _project_level(self, T: SE3, feats: AlignFeatures, fx, fy, cx, cy, level: int):
        scale = 1.0 / (1 << level)
        p = T.apply(feats.points_ref)
        z = torch.where(p[..., 2] < 1e-6, torch.ones_like(p[..., 2]), p[..., 2])
        return torch.stack([(fx * p[..., 0] / z + cx) * scale, (fy * p[..., 1] / z + cy) * scale], -1)

    def precompute_ref_windows(self, ref_pyramid, feats: AlignFeatures, fx: float, fy: float):
        """Per-level (patches (N, P²), J (N, P², 6), visible (N,)) tables of the
        reference keyframe."""
        P = self.patch_size
        out_p, out_J, out_v = [], [], []
        for lv in range(self.min_level, self.max_level + 1):
            uv_l = feats.uv_host * (1.0 / (1 << lv))
            win_r, org_r, ok_r = window_gather(ref_pyramid[lv], uv_l, self.window)
            patches, gx, gy, ok_s = sample_windows_grad(win_r, uv_l - org_r, P)
            row_u, row_v = self._jac_rows(feats, fx, fy, lv)
            J = gx[..., None] * row_u[:, None, :] + gy[..., None] * row_v[:, None, :]
            vis = feats.valid & ok_r & ok_s
            out_p.append(torch.where(vis[:, None], patches, torch.zeros_like(patches)))
            out_J.append(torch.where(vis[:, None, None], J, torch.zeros_like(J)))
            out_v.append(vis)
        return tuple(out_p), tuple(out_J), tuple(out_v)

    def align_precomputed(self, T_init: SE3, tables, cur_pyramid, feats: AlignFeatures,
                          fx: float, fy: float, cx: float, cy: float
                          ) -> Tuple[SE3, torch.Tensor]:
        """Coarse-to-fine alignment; per level: project → gather current
        windows → K1. Returns (T_cur_ref, rmse of the finest level)."""
        t_patches, t_J, t_vis = tables
        T = T_init
        rmse = torch.zeros((), dtype=feats.points_ref.dtype, device=feats.points_ref.device)
        for level in range(self.max_level, self.min_level - 1, -1):
            li = level - self.min_level
            scale = 1.0 / (1 << level)
            uv0 = self._project_level(T, feats, fx, fy, cx, cy, level)
            win_cur, org_c, ok_oc = window_gather(cur_pyramid[level], uv0, self.window)
            T, rmse, _ = lm_align_level(
                T, win_cur, t_patches[li], t_J[li], feats.points_ref, org_c, t_vis[li] & ok_oc,
                fx * scale, fy * scale, cx * scale, cy * scale,
                patch=self.patch_size, max_iters=self.level_iterations(level),
                min_rel_decrease=self.min_rel_decrease,
            )
        return T, rmse
