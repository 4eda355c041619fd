"""Sparse photometric image alignment — port of
``sdvo_tpu.align.image_alignment.SparseImageAlign``, the branches that run K1
(``sdvo_tpu_torch.ops.lm_align``): ``align`` (the per-frame host path:
reference windows gathered per host image each call, the frozen-ESM
Jacobian) and ``precompute_ref_windows`` / ``align_precomputed`` (the device
path: reference tables at keyframe cadence), with ``_project_level`` and
``_jac_rows``.

The constructor takes the reference's arguments with the reference's
defaults (``DEFAULT_SETTINGS``: 12 iterations, relative-decrease exit 1e-3;
``level_taper`` 0; ``use_esm`` on): the host ``System`` builds its aligner
with them, the device path passes its own values. Each level runs
``max(4, max_iterations − level_taper·(max_level − level))`` iterations.
``align_precomputed`` is pure inverse-compositional and ignores ``use_esm``,
as the reference's does.

K1 is a float32 kernel, as the Pallas kernel is: a float64 caller's tables
are cast at its boundary and the pose comes back in the caller's dtype.

With ``settings.visualize`` each level's residuals, robust weights,
visibility and JᵀWJ are evaluated at the pose K1 returned, by the plain
functions in the caller's dtype, and handed to the optimizer's diagnostics
sink under ``settings.viz_tag``: one call a level, as the reference's
per-level ``optimize_lm`` makes. With it off nothing is added.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.ops.lm_align import lm_align_level
from sdvo_tpu_torch.ops.window_sampler import sample_windows, sample_windows_grad, window_gather
from sdvo_tpu_torch.optim.optimizer import LMSettings, _dispatch_diagnostics, _weights_for


class AlignFeatures(NamedTuple):
    """Fixed-capacity SoA batch of alignment features (leading dim N)."""

    uv_host: torch.Tensor  # (N, 2) level-0 pixel position in the host image
    host_idx: torch.Tensor  # (N,) int32 host index (0 on the device path)
    points_ref: torch.Tensor  # (N, 3) point in the reference camera frame
    valid: torch.Tensor  # (N,) bool


class SparseImageAlign:
    """Coarse-to-fine sparse photometric alignment, K1 once a level."""

    DEFAULT_SETTINGS = LMSettings(mad="hist", min_rel_decrease=1e-3, max_iterations=12)

    def __init__(self, patch_size: int = 5, min_level: int = 0, max_level: int = 3,
                 settings: LMSettings = DEFAULT_SETTINGS, use_esm: bool = True, window: int = 16,
                 level_taper: int = 0):
        self.patch_size = int(patch_size)
        self.min_level = int(min_level)
        self.max_level = int(max_level)
        self.settings = settings
        self.use_esm = bool(use_esm)
        self.window = int(window)
        self.level_taper = int(level_taper)

    def level_iterations(self, level: int) -> int:
        return max(4, self.settings.max_iterations - self.level_taper * (self.max_level - level))

    def _run_level(self, T: SE3, win_cur, patches, J, feats: "AlignFeatures", org_c, visible,
                   fx, fy, cx, cy, level: int):
        scale = 1.0 / (1 << level)
        f32 = torch.float32
        return lm_align_level(
            T, win_cur.to(f32), patches.to(f32), J.to(f32), feats.points_ref.to(f32),
            org_c.to(f32), visible, fx * scale, fy * scale, cx * scale, cy * scale,
            patch=self.patch_size, max_iters=self.level_iterations(level),
            min_rel_decrease=self.settings.min_rel_decrease)

    def _emit_diagnostics(self, T: SE3, win_cur, patches, J, feats: AlignFeatures, org_c, visible,
                          fx, fy, cx, cy, level: int):
        """The level's post-solve diagnostics at K1's pose ``T`` (the
        reference's ``residual_fn`` and Optimizer::visualize)."""
        p_cur = T.apply(feats.points_ref)
        vals, ok_s = sample_windows(win_cur, self._project_level(T, feats, fx, fy, cx, cy, level) - org_c,
                                    self.patch_size)
        vis = visible & ok_s & (p_cur[..., 2] > 1e-6)
        r = torch.where(vis[:, None], vals - patches, torch.zeros_like(vals)).reshape(-1)
        vis = vis[:, None].expand(vals.shape).reshape(-1)
        w = _weights_for(self.settings.estimator, r, vis, self.settings.mad)
        Jf = J.reshape(-1, 6)
        H = Jf.T @ (Jf * torch.where(vis, w, torch.zeros_like(w))[:, None])
        _dispatch_diagnostics(self.settings.viz_tag, r, w, vis, H)

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
        windows → K1. Returns (T_cur_ref, rmse of the finest level, K1's
        iterations at each level: int32 (levels,), index ``level −
        min_level``)."""
        t_patches, t_J, t_vis = tables
        T = T_init
        rmse = torch.zeros((), dtype=feats.points_ref.dtype, device=feats.points_ref.device)
        iters = [None] * (self.max_level - self.min_level + 1)
        for level in range(self.max_level, self.min_level - 1, -1):
            li = level - self.min_level
            uv0 = self._project_level(T, feats, fx, fy, cx, cy, level)
            win_cur, org_c, ok_oc = window_gather(cur_pyramid[level], uv0, self.window)
            T, rmse, iters[li] = self._run_level(T, win_cur, t_patches[li], t_J[li], feats, org_c,
                                                 t_vis[li] & ok_oc, fx, fy, cx, cy, level)
            if self.settings.visualize:
                self._emit_diagnostics(T, win_cur, t_patches[li], t_J[li], feats, org_c,
                                       t_vis[li] & ok_oc, fx, fy, cx, cy, level)
        return T, rmse, torch.stack(iters)

    def align(self, T_init: SE3, host_pyramid: Sequence[torch.Tensor],
              cur_pyramid: Sequence[torch.Tensor], feats: AlignFeatures,
              fx: float, fy: float, cx: float, cy: float
              ) -> Tuple[SE3, torch.Tensor, torch.Tensor]:
        """Coarse-to-fine alignment against the host images themselves.
        ``host_pyramid[level]`` is (n_hosts, H_l, W_l); each feature takes its
        reference window from the host ``feats.host_idx`` names. With
        ``use_esm`` the Jacobian averages the reference gradients with the
        current image's, sampled once at the level's first projection.
        Returns (T_cur_ref, rmse of the finest level, status 0)."""
        P = self.patch_size
        N = feats.uv_host.shape[0]
        dev = feats.points_ref.device
        T = T_init
        rmse = torch.zeros((), dtype=feats.points_ref.dtype, device=dev)
        rows = torch.arange(N, device=dev)
        host = feats.host_idx.to(torch.int64)
        for level in range(self.max_level, self.min_level - 1, -1):
            uv_ref_l = feats.uv_host * (1.0 / (1 << level))
            refs = [window_gather(im, uv_ref_l, self.window) for im in host_pyramid[level]]
            win_ref = torch.stack([r[0] for r in refs])[host, rows]
            org_ref = torch.stack([r[1] for r in refs])[host, rows]
            patches, gx_r, gy_r, ok_r = sample_windows_grad(win_ref, uv_ref_l - org_ref, P)
            visible = feats.valid & refs[0][2] & ok_r
            row_u, row_v = self._jac_rows(feats, fx, fy, level)

            uv0 = self._project_level(T, feats, fx, fy, cx, cy, level)
            win_cur, org_c, ok_oc = window_gather(cur_pyramid[level], uv0, self.window)
            visible = visible & ok_oc
            patches = torch.where(visible[:, None], patches, torch.zeros_like(patches))
            if self.use_esm:
                _, gcx, gcy, _ = sample_windows_grad(win_cur, uv0 - org_c, P)
                gx, gy = 0.5 * (gx_r + gcx), 0.5 * (gy_r + gcy)
            else:
                gx, gy = gx_r, gy_r
            J = gx[..., None] * row_u[:, None, :] + gy[..., None] * row_v[:, None, :]
            J = torch.where(visible[:, None, None], J, torch.zeros_like(J))
            T, rmse, _ = self._run_level(T, win_cur, patches, J, feats, org_c, visible,
                                         fx, fy, cx, cy, level)
            if self.settings.visualize:
                self._emit_diagnostics(T, win_cur, patches, J, feats, org_c, visible, fx, fy, cx, cy, level)
        return T, rmse, torch.zeros((), dtype=torch.int32, device=dev)
