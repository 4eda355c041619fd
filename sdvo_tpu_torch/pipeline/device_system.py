"""Device-resident VO — port of ``sdvo_tpu.pipeline.device_system``
(``DeviceVO`` and ``DeviceSystem``).

The whole steady-state loop runs on the device over a ``VOState`` of
fixed-shape tensors: one *superstep* is ``keyframe_every_n`` frames, the last
of which adds the keyframe program (feature insertion, depth-seed
promotion, re-detection, windowed Schur BA, eviction). Shapes are fixed and
the superstep never reads a device value on the host, so on the card a chunk
runs as a CUDA graph (``pipeline.cuda_graph``), the counterpart of the
reference's ``chunk_fn`` (a ``jax.jit`` of ``lax.scan``): one graph for a
whole chunk of ``chunk_supersteps`` supersteps, and one of a single superstep
replayed for any other count. On the CPU a chunk is the Python loop
(``run_chunk_eager``).

Per frame the four hand-written kernels run: K1 four times (one per
pyramid level, ``align_precomputed``), K2 once (``reproject_device``), K3
once (the pose polish) and K4 once (``update_filters``).

``DeviceSystem`` is the host wrapper. It holds a host ``System``
(``pipeline.system``): the two-view bootstrap runs through it and ``_pack``
builds the ``VOState`` from its arena; when tracking fails inside a chunk,
``to_host`` unpacks the state and the host relocalizes frame by frame until
``_pack`` puts the state back on the device. ``save_checkpoint`` goes
through the host too.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sdvo_tpu_torch.align.image_alignment import AlignFeatures, SparseImageAlign
from sdvo_tpu_torch.ba.bundle_adjustment import BAObservations, BASettings, local_ba
from sdvo_tpu_torch.config import Config
from sdvo_tpu_torch.dataio.poses import write_kitti_poses
from sdvo_tpu_torch.depth.filter import FilterBank, init_filters, update_filters
from sdvo_tpu_torch.device import deterministic_on, resolve_device
from sdvo_tpu_torch.features.detection import detect_gradient_by_value
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.geometry.essential import topk_stable
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.interp import padded_patch_and_gradients
from sdvo_tpu_torch.image.pyramid import build_pyramid
from sdvo_tpu_torch.mapping.device_map import (
    DeviceMap,
    PointType,
    alloc_free_slots,
    evict_furthest_keyframe,
    orphan_point_cleanup,
    reproject_device,
)
from sdvo_tpu_torch.ops.pose_refine import pose_refine
from sdvo_tpu_torch.optim.optimizer import tree_where
from sdvo_tpu_torch.ops.window_sampler import sample_windows, sample_windows_grad, window_gather
from sdvo_tpu_torch.pipeline.cuda_graph import GraphedCall
from sdvo_tpu_torch.pipeline.system import FrameResult, System, SystemStatus

INT32_MAX = 2 ** 31 - 1


class DeviceFilters(NamedTuple):
    """FilterBank + the feature-alignment patch tables of each seed."""

    bank: FilterBank
    fa_patch: torch.Tensor  # (C, P2) gradient patch at uv_ref
    fa_gx: torch.Tensor
    fa_gy: torch.Tensor
    fa_ok: torch.Tensor  # (C,) bool
    pending: torch.Tensor  # (C,) bool — converged, awaiting keyframe promotion
    pend_mu: torch.Tensor  # (C,) inverse depth at convergence


class TrackRef(NamedTuple):
    """Tracking reference = the newest keyframe."""

    pyr_images: Tuple[torch.Tensor, ...]
    T_ref_w: SE3
    ref_slot: torch.Tensor  # () int32
    feats: AlignFeatures
    align_patches: Tuple[torch.Tensor, ...]
    align_J: Tuple[torch.Tensor, ...]
    align_vis: Tuple[torch.Tensor, ...]


class VOState(NamedTuple):
    map: DeviceMap
    filt: DeviceFilters
    ref: TrackRef
    T_cur_ref: SE3  # last tracked pose relative to ref (the constant-velocity seed)
    frame_id: torch.Tensor  # () int32 — id of the NEXT frame
    failed: torch.Tensor  # () bool — tracking lost


class FrameOut(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    ok: torch.Tensor
    is_kf: torch.Tensor
    rmse: torch.Tensor
    n_matches: torch.Tensor
    n_filters: torch.Tensor
    n_points: torch.Tensor


class SuperstepConfig(NamedTuple):
    period: int  # keyframe_every_n
    levels: int
    patch_align: int
    patch_fa: int
    patch_filter: int
    cell_size: int
    max_matches: int
    max_error: float
    min_tracked: int
    max_dropped: int
    max_keyframes: int
    max_promote: int
    ba_points: int
    ba_iterations: int
    epipolar_steps: int
    staleness: int
    convergence_factor: float
    grad_threshold: float
    ba_presolve: int = 0  # structure-only passes of the windowed BA before its joint solve


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor without reading it on the host."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def _orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt re-orthonormalisation (float32 drift guard)."""
    r0 = R[..., 0, :]
    r1 = R[..., 1, :]
    r0 = r0 / torch.clamp(torch.linalg.norm(r0, dim=-1, keepdim=True), min=1e-12)
    r1 = r1 - torch.sum(r0 * r1, dim=-1, keepdim=True) * r0
    r1 = r1 / torch.clamp(torch.linalg.norm(r1, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([r0, r1, torch.linalg.cross(r0, r1, dim=-1)], dim=-2)


def _masked_median(x: torch.Tensor, mask: torch.Tensor, fill: float) -> torch.Tensor:
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, big))).values
    n = mask.to(torch.int64).sum()
    v = take(xs, torch.clamp(n - 1, min=0) // 2)
    return torch.where(n > 0, v, torch.full_like(v, fill))


def _project_uv(T: SE3, p_w, fx, fy, cx, cy):
    p = T.apply(p_w)
    z = torch.where(torch.abs(p[..., 2]) < 1e-9, torch.full_like(p[..., 2], 1e-9), p[..., 2])
    return p, torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], dim=-1)


def _in_border(p, uv, W, H, b=8):
    return (p[..., 2] > 1e-6) & (uv[..., 0] >= b) & (uv[..., 1] >= b) & (uv[..., 0] < W - b) & (uv[..., 1] < H - b)


class DeviceVO:
    """Steady-state VO: superstep + chunk over a ``VOState``. On the card
    ``chunk_graph`` (a chunk of ``chunk_supersteps`` supersteps) and
    ``step_graph`` (one superstep) hold its CUDA graphs, each captured at its
    first use."""

    def __init__(self, cam: PinholeCamera, cfg: SuperstepConfig, dtype=torch.float32,
                 chunk_supersteps: int = 8):
        self.cam = cam
        self.cfg = cfg
        self.dtype = dtype
        self.chunk_supersteps = chunk_supersteps
        self.chunk_graph = GraphedCall(self.run_chunk_eager, "DeviceVO.chunk")
        self.step_graph = GraphedCall(self.superstep, "DeviceVO.superstep")
        self.aligner = SparseImageAlign(
            patch_size=cfg.patch_align, min_level=0, max_level=cfg.levels - 1,
            settings=SparseImageAlign.DEFAULT_SETTINGS._replace(max_iterations=10,
                                                                min_rel_decrease=2e-3),
            level_taper=2)

    # ------------------------------------------------------------ frame step
    def _frame_step(self, state: VOState, image: torch.Tensor, is_kf: bool):
        cfg, cam = self.cfg, self.cam
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        pyr = build_pyramid(image, cfg.levels)

        # 2. sparse image alignment vs the reference keyframe (K1 per level)
        T_est, rmse = self.aligner.align_precomputed(
            state.T_cur_ref, (state.ref.align_patches, state.ref.align_J, state.ref.align_vis),
            pyr.images, state.ref.feats, fx, fy, cx, cy)
        T_cur_w = T_est.compose(state.ref.T_ref_w)

        # 3. map reprojection + feature alignment (K2)
        m, matches = reproject_device(
            state.map, T_cur_w, pyr.base_gradient, fx, fy, cx, cy, cell_size=cfg.cell_size,
            max_matches=cfg.max_matches, max_error=cfg.max_error, patch_size=cfg.patch_fa,
            frame_salt=state.frame_id)

        # 4. bearing-residual pose polish (K3)
        pts_w = m.pt_pos[matches.pt_slot]
        bearings = cam.backproject(matches.uv.to(self.dtype))
        T_pol, _, _ = pose_refine(T_cur_w, pts_w, bearings, matches.good, max_iters=8,
                                  min_rel_decrease=1e-3)
        use_ref = matches.n_good >= 10
        T_cur_w = SE3(torch.where(use_ref, T_pol.rotation, T_cur_w.rotation),
                      torch.where(use_ref, T_pol.translation, T_cur_w.translation))

        # 5. tracking-quality gate with pose freeze on failure
        ref_obs = state.ref.feats.valid.to(torch.int32).sum()
        fail_now = (matches.n_good < cfg.min_tracked) | ((ref_obs - matches.n_good) > cfg.max_dropped)
        failed = state.failed | fail_now
        T_cur_w = tree_where(failed, state.ref.T_ref_w, T_cur_w)

        # 6. depth-filter update with per-filter relative poses (K4)
        filt = state.filt
        kf_slots = filt.bank.kf_slot.to(torch.int64)
        R_rel = torch.einsum("ij,ckj->cik", T_cur_w.rotation, m.kf_R[kf_slots])
        t_rel = T_cur_w.translation[None] - torch.einsum("cik,ck->ci", R_rel, m.kf_t[kf_slots])
        bank, converged = update_filters(
            filt.bank, SE3(R_rel, t_rel), pyr.base_image, fx, fy, cx, cy,
            kf_counter=m.kf_counter, patch_size=cfg.patch_filter, num_steps=cfg.epipolar_steps,
            staleness=cfg.staleness, convergence_factor=cfg.convergence_factor)
        converged = converged & ~failed
        filt = filt._replace(bank=bank, pending=filt.pending | converged,
                             pend_mu=torch.where(converged, bank.mu, filt.pend_mu))

        # once tracking is lost the map/filter state freezes; only the frame
        # counter advances
        R_ref, t_ref = state.ref.T_ref_w
        R_cr = T_cur_w.rotation @ R_ref.T
        T_cur_ref_new = SE3(R_cr, T_cur_w.translation - R_cr @ t_ref)
        state = state._replace(
            map=tree_where(failed, state.map, m),
            filt=tree_where(failed, state.filt, filt),
            T_cur_ref=tree_where(failed, state.T_cur_ref, T_cur_ref_new),
            frame_id=state.frame_id + 1,
            failed=failed,
        )
        if is_kf:
            state, T_cur_w = self._keyframe_step(state, pyr, T_cur_w, matches)
        out = FrameOut(
            R=T_cur_w.rotation, t=T_cur_w.translation, ok=~failed, is_kf=(~failed) & is_kf,
            rmse=rmse, n_matches=matches.n_good,
            n_filters=state.filt.bank.valid.to(torch.int32).sum(),
            n_points=state.map.pt_valid.to(torch.int32).sum(),
        )
        return state, out

    # --------------------------------------------------------- keyframe step
    def _grad_patches(self, grad, uv):
        w, org, okw = window_gather(grad, uv, win_h=12)
        p, gx, gy, oks = sample_windows_grad(w, uv - org, self.cfg.patch_fa)
        return p, gx, gy, okw & oks

    def _keyframe_step(self, state: VOState, pyr, T_cur_w: SE3, matches):
        cfg, cam = self.cfg, self.cam
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        m, filt = state.map, state.filt
        K, F = m.feat_valid.shape
        P = m.pt_pos.shape[0]
        M = matches.pt_slot.shape[0]
        NP = cfg.max_promote
        dtype = self.dtype
        dev = m.pt_pos.device
        frozen = state.failed  # on failure the keyframe step is a no-op
        i32 = torch.int32
        H_img, W_img = pyr.base_image.shape

        # 7. allocate the keyframe slot
        slot = torch.argmax((~m.kf_valid).to(i32))
        onehot = torch.arange(K, device=dev) == slot
        kf_R = torch.where(onehot[:, None, None], _orthonormalize(T_cur_w.rotation)[None], m.kf_R)
        kf_t = torch.where(onehot[:, None], T_cur_w.translation[None], m.kf_t)
        kf_valid = m.kf_valid | onehot
        kf_frame_id = torch.where(onehot, state.frame_id - 1, m.kf_frame_id)

        # 8. features of the new keyframe: the frame's matches (rows 0..M)
        f_patch, f_gx, f_gy, f_ok = self._grad_patches(pyr.base_gradient, matches.uv)
        pad = F - M

        def rows(x, fill=0):
            return torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype, device=dev)])

        row_uv = rows(matches.uv.to(dtype))
        # the reference writes ``-jnp.ones(...).at[:M].set(pt_slot)``, which
        # binds as ``-(…)``: matched rows hold −slot (detached from their
        # points, except slot 0) and pad rows −1. Kept so that both packages
        # agree state for state; ROADMAP.md lists the fix for both.
        row_pt = -rows(matches.pt_slot.to(i32), 1)
        row_val = rows(matches.good & f_ok, False)
        row_patch, row_gx, row_gy = rows(f_patch), rows(f_gx), rows(f_gy)
        row_ok = rows(f_ok, False)

        # 9. promote pending depth filters to CANDIDATE points, anchored in
        #    their HOST keyframe's feature table
        pv, p_idx = topk_stable(filt.pending.to(i32), NP)
        p_live = pv > 0
        depth = 1.0 / torch.clamp(filt.pend_mu[p_idx], min=1e-9)
        host = filt.bank.kf_slot[p_idx].to(torch.int64)
        p_kf = filt.bank.bearing_ref[p_idx] * depth[:, None]
        p_w = torch.einsum("nji,nj->ni", m.kf_R[host], p_kf - m.kf_t[host])
        ar = torch.arange(NP, device=dev)
        earlier = (host[None, :] == host[:, None]) & (ar[None, :] < ar[:, None]) & p_live[None, :]
        rank = earlier.to(i32).sum(1)
        kk = min(NP, F)
        fval, fidx = topk_stable((~m.feat_valid).to(i32), kk)
        rank_c = torch.clamp(rank, max=kk - 1).to(torch.int64)
        fi = fidx[host, rank_c]
        host_row_free = (fval[host, rank_c] > 0) & (rank == rank_c)
        pt_slots, pt_free = alloc_free_slots(m.pt_valid, NP)
        p_add = p_live & pt_free & host_row_free & filt.fa_ok[p_idx] & ~frozen

        def pt_set(tbl, value):
            return tbl.index_copy(0, pt_slots, torch.where(
                p_add.reshape((-1,) + (1,) * (tbl.ndim - 1)), value, tbl[pt_slots]))

        pt_pos = pt_set(m.pt_pos, p_w.to(dtype))
        pt_type = pt_set(m.pt_type, torch.full_like(m.pt_type[:NP], int(PointType.CANDIDATE)))
        pt_valid = pt_set(m.pt_valid, torch.ones_like(m.pt_valid[:NP]))
        pt_succ = pt_set(m.pt_succ, torch.zeros_like(m.pt_succ[:NP]))
        pt_fail = pt_set(m.pt_fail, torch.zeros_like(m.pt_fail[:NP]))
        taken = torch.zeros_like(filt.pending).index_copy(0, p_idx, p_live & ~frozen)
        filt = filt._replace(pending=filt.pending & ~taken)

        def row_write(tbl, row):
            new = torch.where(onehot.reshape((K,) + (1,) * (tbl.ndim - 1)), row[None], tbl)
            return torch.where(frozen, tbl, new)

        m = m._replace(
            kf_R=torch.where(frozen, m.kf_R, kf_R), kf_t=torch.where(frozen, m.kf_t, kf_t),
            kf_valid=torch.where(frozen, m.kf_valid, kf_valid),
            kf_frame_id=torch.where(frozen, m.kf_frame_id, kf_frame_id),
            kf_counter=torch.where(frozen, m.kf_counter, m.kf_counter + 1),
            kf_img0=row_write(m.kf_img0, pyr.base_image),
            feat_uv=row_write(m.feat_uv, row_uv), feat_point=row_write(m.feat_point, row_pt),
            feat_valid=row_write(m.feat_valid, row_val), feat_patch=row_write(m.feat_patch, row_patch),
            feat_gx=row_write(m.feat_gx, row_gx), feat_gy=row_write(m.feat_gy, row_gy),
            feat_ok=row_write(m.feat_ok, row_ok),
            pt_pos=torch.where(frozen, m.pt_pos, pt_pos), pt_type=torch.where(frozen, m.pt_type, pt_type),
            pt_valid=torch.where(frozen, m.pt_valid, pt_valid),
            pt_succ=torch.where(frozen, m.pt_succ, pt_succ), pt_fail=torch.where(frozen, m.pt_fail, pt_fail),
        )
        # the promoted observation rows: (host, fi); not-added promotions go to
        # a spare block of rows that is cut off again (mode="drop")
        flat = torch.where(p_add, host * F + fi, K * F + fi)

        def hscat(tbl, newv):
            tail = tbl.shape[2:]
            padded = torch.cat([tbl.reshape((K * F,) + tail), tbl.new_zeros((F,) + tail)])
            padded = padded.index_put((flat,), newv.to(tbl.dtype))
            return padded[: K * F].reshape(tbl.shape)

        ones = torch.ones((NP,), dtype=torch.bool, device=dev)
        m = m._replace(
            feat_uv=hscat(m.feat_uv, filt.bank.uv_ref[p_idx]), feat_point=hscat(m.feat_point, pt_slots),
            feat_valid=hscat(m.feat_valid, ones), feat_patch=hscat(m.feat_patch, filt.fa_patch[p_idx]),
            feat_gx=hscat(m.feat_gx, filt.fa_gx[p_idx]), feat_gy=hscat(m.feat_gy, filt.fa_gy[p_idx]),
            feat_ok=hscat(m.feat_ok, ones),
        )

        # 10. re-detection + depth-filter seeding
        p_cam_p, uvp = _project_uv(T_cur_w, p_w, fx, fy, cx, cy)
        inb_p = _in_border(p_cam_p, uvp, W_img, H_img)
        gc, gr = W_img // cfg.cell_size, H_img // cfg.cell_size
        occ_uv = torch.cat([row_uv, uvp.to(dtype)])
        occ_val = torch.cat([row_val, p_add & inb_p])
        cellx = torch.clamp(torch.clamp(occ_uv[:, 0] / cfg.cell_size, -1.0, float(gc)).to(i32), 0, gc - 1)
        celly = torch.clamp(torch.clamp(occ_uv[:, 1] / cfg.cell_size, -1.0, float(gr)).to(i32), 0, gr - 1)
        occ = torch.zeros((gr * gc,), dtype=i32, device=dev).index_add(
            0, (celly * gc + cellx).to(torch.int64), occ_val.to(i32)).reshape(gr, gc) > 0
        uv_det, _, det_val = detect_gradient_by_value(pyr.base_gradient, cfg.grad_threshold,
                                                      cfg.cell_size, occupied=occ)
        C_det = uv_det.shape[0]
        z_m = T_cur_w.apply(m.pt_pos[matches.pt_slot])[..., 2]
        depth_mean = _masked_median(z_m, matches.good, fill=1.0)
        depth_min = torch.where(matches.good, z_m, torch.full_like(z_m, float("inf"))).min()
        depth_min = torch.where(torch.isfinite(depth_min), depth_min, torch.full_like(depth_min, 0.1))
        w_i, org_i, ok_i = window_gather(pyr.base_image, uv_det, win_h=12)
        s_patch, s_ok2 = sample_windows(w_i, uv_det - org_i, cfg.patch_filter)
        sg_patch, sg_gx, sg_gy, sg_ok = self._grad_patches(pyr.base_gradient, uv_det)
        new_bank = init_filters(
            uv_det.to(dtype), cam.backproject(uv_det.to(dtype)), s_patch, kf_slot=slot.to(i32),
            depth_mean=torch.clamp(depth_mean, min=1e-3), depth_min=torch.clamp(0.5 * depth_min, min=1e-4),
            kf_counter=m.kf_counter, new_valid=det_val & ok_i & s_ok2 & ~frozen, dtype=dtype)
        f_slots, f_free = alloc_free_slots(filt.bank.valid | filt.pending, C_det)
        ins = new_bank.valid & f_free

        def scatter_field(old, new):
            return old.index_copy(0, f_slots, torch.where(
                ins.reshape((-1,) + (1,) * (old.ndim - 1)), new.to(old.dtype), old[f_slots]))

        bank = FilterBank(*[scatter_field(o, n) for o, n in zip(filt.bank, new_bank)])
        filt = DeviceFilters(
            bank=bank, fa_patch=scatter_field(filt.fa_patch, sg_patch),
            fa_gx=scatter_field(filt.fa_gx, sg_gx), fa_gy=scatter_field(filt.fa_gy, sg_gy),
            fa_ok=scatter_field(filt.fa_ok, sg_ok),
            pending=scatter_field(filt.pending, torch.zeros_like(ins)), pend_mu=filt.pend_mu,
        )

        # 11. windowed Schur bundle adjustment
        m, T_kf_post = self._run_ba(m, slot, frozen)
        T_cur_w = tree_where(frozen, T_cur_w, T_kf_post)

        # 12. sliding-window eviction
        m_e, evicted = evict_furthest_keyframe(m, slot, cfg.max_keyframes)
        m = tree_where(frozen, m, m_e)
        drop = (~frozen) & (evicted >= 0) & (bank.kf_slot == evicted)
        filt = filt._replace(bank=filt.bank._replace(valid=filt.bank.valid & ~drop),
                             pending=filt.pending & ~drop)

        # 13. new tracking reference: the keyframe's feature row plus the
        #     freshly promoted candidates in rows M..M+NP
        feat_point_s = take(m.feat_point, slot)
        feat_pt = torch.clamp(feat_point_s, 0, P - 1).to(torch.int64)
        fvalid = take(m.feat_valid, slot) & (feat_point_s >= 0) & m.pt_valid[feat_pt]
        p_ref = T_cur_w.apply(m.pt_pos[feat_pt])
        p_ref_p, uvp_post = _project_uv(T_cur_w, m.pt_pos[pt_slots], fx, fy, cx, cy)
        track_valid = p_add & _in_border(p_ref_p, uvp_post, W_img, H_img) & m.pt_valid[pt_slots]

        def splice(base, mid):
            return torch.cat([base[:M], mid, base[M + NP:]])

        feats = AlignFeatures(
            uv_host=splice(take(m.feat_uv, slot).to(dtype), uvp_post.to(dtype)),
            host_idx=torch.zeros((F,), dtype=i32, device=dev),
            points_ref=splice(p_ref.to(dtype), p_ref_p.to(dtype)),
            valid=splice(fvalid & (p_ref[..., 2] > 1e-3), track_valid & (p_ref_p[..., 2] > 1e-3)),
        )
        t_patches, t_J, t_vis = self.aligner.precompute_ref_windows(pyr.images, feats, fx, fy)
        new_ref = TrackRef(pyr_images=tuple(pyr.images), T_ref_w=T_cur_w, ref_slot=slot.to(i32),
                           feats=feats, align_patches=t_patches, align_J=t_J, align_vis=t_vis)
        ref = tree_where(frozen, state.ref, new_ref)
        T_cur_ref = tree_where(frozen, state.T_cur_ref, SE3.identity(dtype=dtype, device=dev))
        return state._replace(map=m, filt=filt, ref=ref, T_cur_ref=T_cur_ref), T_cur_w

    def _run_ba(self, m: DeviceMap, new_slot: torch.Tensor, frozen: torch.Tensor):
        """Local BA over the arena window; landmarks compacted to ``ba_points``,
        gauge = the two oldest keyframes fixed; chi² observation pruning."""
        cfg, cam = self.cfg, self.cam
        K, F = m.feat_valid.shape
        P = m.pt_pos.shape[0]
        PB = cfg.ba_points
        dev = m.pt_pos.device
        i64 = torch.int64
        sel_val, sel_p = topk_stable(m.pt_valid.to(torch.int32), PB)
        p_live = sel_val > 0
        # as the reference's ``-jnp.ones(...).at[sel_p].set(...)`` binds:
        # −(dense index) for live points, +1 for dead selected slots, −1
        # elsewhere; so only dense point 0 (and dead slots) keep observations
        # and ``do_ba`` rarely holds. Kept for state parity (see row_pt).
        dense_of = -(torch.ones((P,), dtype=i64, device=dev).index_copy(
            0, sel_p, torch.where(p_live, torch.arange(PB, device=dev), torch.full_like(sel_p, -1))))
        KF = K * F
        fp = m.feat_point.reshape(KF)
        dense_pt = dense_of[torch.clamp(fp, 0, P - 1).to(i64)]
        obs_ok = m.feat_valid.reshape(KF) & (fp >= 0) & (dense_pt >= 0)
        obs = BAObservations(cam_idx=torch.repeat_interleave(torch.arange(K, device=dev), F),
                             pt_idx=torch.clamp(dense_pt, min=0), uv=m.feat_uv.reshape(KF, 2).to(self.dtype),
                             valid=obs_ok)
        fr = torch.where(m.kf_valid, m.kf_frame_id, torch.full_like(m.kf_frame_id, INT32_MAX))
        o1 = torch.argmin(fr)
        ar = torch.arange(K, device=dev)
        o2 = torch.argmin(torch.where(ar == o1, torch.full_like(fr, INT32_MAX), fr))
        fixed_cam = ~m.kf_valid | (ar == o1) | (ar == o2)
        do_ba = (~frozen) & (m.kf_valid.to(torch.int32).sum() >= 3) & (obs_ok.to(torch.int32).sum() >= 20)
        poses_out, pts_out, chi2_obs, _ = local_ba(
            m.kf_pose(), m.pt_pos[sel_p].to(self.dtype), obs, fixed_cam, ~p_live,
            cam.fx, cam.fy, cam.cx, cam.cy,
            settings=BASettings(iterations=cfg.ba_iterations, huber_delta=2.0, min_rel_decrease=1e-3,
                                structure_presolve=cfg.ba_presolve))
        kf_R = torch.where(do_ba, _orthonormalize(poses_out.rotation), m.kf_R)
        kf_t = torch.where(do_ba, poses_out.translation, m.kf_t)
        pt_pos = m.pt_pos.index_copy(0, sel_p, torch.where((p_live & do_ba)[:, None], pts_out, m.pt_pos[sel_p]))
        bad = do_ba & obs_ok & (chi2_obs > 5.991)
        m = m._replace(kf_R=kf_R, kf_t=kf_t, pt_pos=pt_pos, feat_valid=m.feat_valid & ~bad.reshape(K, F))
        return orphan_point_cleanup(m), SE3(take(kf_R, new_slot), take(kf_t, new_slot))

    # ------------------------------------------------------------- superstep
    def superstep(self, state: VOState, images: torch.Tensor):
        """``period`` frames, the last a keyframe. Returns (state, FrameOut
        with a leading (period,) axis)."""
        outs = []
        for i in range(self.cfg.period):
            state, out = self._frame_step(state, images[i], is_kf=(i == self.cfg.period - 1))
            outs.append(out)
        return state, FrameOut(*[torch.stack(x) for x in zip(*outs)])

    def run_chunk(self, state: VOState, images: torch.Tensor):
        """images (C, period, H, W) → (state, FrameOut with (C, period) axes).
        On the card a replay of the captured chunk when C is
        ``chunk_supersteps``, else C replays of the captured superstep; the
        state and outputs are fresh tensors. On the CPU ``run_chunk_eager``."""
        if images.device.type != "cuda":
            return self.run_chunk_eager(state, images)
        if images.shape[0] == self.chunk_supersteps:
            return self.chunk_graph(state, images)
        outs = []
        for c in range(images.shape[0]):
            state, out = self.step_graph(state, images[c])
            outs.append(out)
        return state, FrameOut(*[torch.stack(x) for x in zip(*outs)])

    def run_chunk_eager(self, state: VOState, images: torch.Tensor):
        """``run_chunk`` as a Python loop of eager supersteps, on any device."""
        outs = []
        for c in range(images.shape[0]):
            state, out = self.superstep(state, images[c])
            outs.append(out)
        return state, FrameOut(*[torch.stack(x) for x in zip(*outs)])


# ===========================================================================
# Host wrapper: bootstrap on the host System, steady state on the device
# ===========================================================================


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: min(len(a), n)] = a[:n]
    return out


class DeviceSystem:
    """VO front end with a device-resident steady state (``add_image`` /
    ``finish`` / ``trajectory`` / ``write_poses`` / ``save_checkpoint``).

    The bootstrap (the first two keyframes) runs through the host ``System``
    (``self.host``) and ``_pack`` puts its arena, filters and tracking
    reference on the device. From then on frames are buffered and consumed
    ``supersteps_per_chunk × keyframe_every_n`` at a time by one chunk.
    ``finish()`` flushes the buffer (the tail superstep is padded by repeating
    the last frame; padded outputs are dropped). A tracking failure inside a
    chunk freezes the device state for the rest of the chunk; then
    ``_relocalize`` unpacks to the host (``to_host``), which steps frame by
    frame in ``RELOCALIZATION`` until tracking is healthy and the reference
    frame is a keyframe again, and ``_pack`` re-enters the device path.

    ``ransac_uniforms`` and ``seed`` go to the host ``System``. ``device``
    defaults to the CUDA card and raises where there is none;
    ``device="cpu"`` asks for the CPU (the kernels' plain versions). On the
    card every chunk runs with PyTorch's deterministic algorithms
    (``device.deterministic_on``): the bundle adjustment's float
    ``index_add``s and ``hscat``'s ``index_put`` would otherwise sum by
    atomic adds in a new order every run, so a run gives the same bits every
    time.
    """

    def __init__(self, config: Config, camera: Optional[PinholeCamera] = None, seed: int = 0,
                 supersteps_per_chunk: int = 8, max_promote: int = 64, ba_points: int = 1024,
                 ba_iterations: int = 2, device=None, ransac_uniforms: Optional[np.ndarray] = None,
                 ba_presolve: Optional[int] = None):
        self.config = config
        self.device = resolve_device(device)
        cfg_a = config.algorithm
        if config.compute_dtype != "float32":
            raise ValueError("the port's device path is float32")
        if cfg_a.max_reprojection_matches + max_promote > cfg_a.max_features_per_frame:
            raise ValueError("alignment feature set must hold matches + promoted candidates")
        self.host = System(config, camera, seed, device=self.device, ransac_uniforms=ransac_uniforms)
        self.camera = self.host.camera
        self.scfg = SuperstepConfig(
            period=cfg_a.keyframe_every_n, levels=cfg_a.max_level_image_pyramid + 1,
            patch_align=cfg_a.patch_size_image_alignment, patch_fa=cfg_a.patch_size_feature_alignment,
            patch_filter=7, cell_size=cfg_a.cell_pixel_size, max_matches=cfg_a.max_reprojection_matches,
            max_error=cfg_a.feature_alignment_max_error, min_tracked=cfg_a.min_tracked_features,
            max_dropped=cfg_a.max_dropped_features, max_keyframes=cfg_a.max_keyframes,
            max_promote=max_promote, ba_points=min(ba_points, cfg_a.max_points),
            ba_iterations=ba_iterations, epipolar_steps=cfg_a.epipolar_search_steps,
            staleness=cfg_a.filter_staleness_keyframes,
            convergence_factor=cfg_a.filter_convergence_sigma_factor,
            grad_threshold=float(config.initialization.threshold_gradient_magnitude),
            ba_presolve=cfg_a.ba_structure_presolve if ba_presolve is None else ba_presolve,
        )
        self.vo = DeviceVO(self.camera, self.scfg, chunk_supersteps=supersteps_per_chunk)
        self.supersteps_per_chunk = supersteps_per_chunk
        self.state: Optional[VOState] = None
        self.trajectory: List[Optional[np.ndarray]] = []
        self.metrics: List[Dict] = []
        self._buffer: List[np.ndarray] = []
        self.n_relocalizations = 0

    @property
    def bootstrapped(self) -> bool:
        return self.state is not None

    # ----------------------------------------------------------------- pack
    def _pack(self):
        """Host arena + filters + tracking reference → the device ``VOState``."""
        sys_ = self.host
        a = sys_.arena
        dev = self.device
        f32, i32 = torch.float32, torch.int32
        K, F, P = a.max_keyframes, a.max_features_per_kf, a.max_points
        P2 = a.align_patch_size ** 2

        def t(x, dtype=f32):
            return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

        kf_img0 = torch.zeros((K, sys_.height, sys_.width), dtype=f32, device=dev)
        for s in a.keyframe_slots():
            if a.kf_pyramids[s] is not None:
                kf_img0[s] = a.kf_pyramids[s].base_image.to(f32)
        m = DeviceMap(
            kf_R=t(a.kf_pose[:, :3, :3]), kf_t=t(a.kf_pose[:, :3, 3]), kf_valid=t(a.kf_valid, torch.bool),
            kf_frame_id=t(a.kf_frame_id, i32), kf_counter=t(a.kf_counter, i32), kf_img0=kf_img0,
            feat_uv=t(a.feat_uv), feat_point=t(a.feat_point, i32), feat_valid=t(a.feat_valid, torch.bool),
            feat_patch=t(a.feat_patch), feat_gx=t(a.feat_gx), feat_gy=t(a.feat_gy),
            feat_ok=t(a.feat_patch_ok, torch.bool), pt_pos=t(a.pt_pos), pt_type=t(a.pt_type, i32),
            pt_valid=t(a.pt_valid, torch.bool), pt_succ=t(a.pt_succeeded, i32),
            pt_fail=t(a.pt_failed, i32),
        )
        # the filter bank + the feature-alignment tables of each seed, sampled
        # from its host keyframe's gradient image
        bank = sys_.filters
        C = bank.mu.shape[0]
        fa = [torch.zeros((C, P2), dtype=f32, device=dev) for _ in range(3)]
        fa_ok = torch.zeros((C,), dtype=torch.bool, device=dev)
        valid_np = bank.valid.cpu().numpy()
        kf_slots = bank.kf_slot.cpu().numpy()
        for s in np.unique(kf_slots[valid_np]):
            if not a.kf_valid[s] or a.kf_pyramids[s] is None:
                continue
            rows = torch.as_tensor(np.nonzero(valid_np & (kf_slots == s))[0], device=dev)
            *tabs, ok = padded_patch_and_gradients(a.kf_pyramids[s].base_gradient, bank.uv_ref[rows],
                                                   sys_.config.algorithm.patch_size_feature_alignment)
            for tab, val in zip(fa, tabs):
                tab[rows] = val.to(f32)
            fa_ok[rows] = ok
        filt = DeviceFilters(bank=bank, fa_patch=fa[0], fa_gx=fa[1], fa_gy=fa[2], fa_ok=fa_ok,
                             pending=torch.zeros((C,), dtype=torch.bool, device=dev),
                             pend_mu=torch.zeros((C,), dtype=f32, device=dev))

        # tracking reference = the host's reference frame (the newest keyframe)
        ref_rec = sys_.ref_frame
        T_ref = ref_rec.pose_wc
        uv = _pad_rows(np.asarray(ref_rec.feat_uv, np.float64), F)
        pts = _pad_rows(np.asarray(ref_rec.feat_point, np.int64), F)
        n = min(len(ref_rec.feat_uv), F)
        val = np.zeros(F, bool)
        val[:n] = a.pt_valid[pts[:n]]
        p_ref = a.pt_pos[np.clip(pts, 0, P - 1)] @ T_ref[:3, :3].T + T_ref[:3, 3]
        val &= p_ref[:, 2] > 1e-3
        feats = AlignFeatures(uv_host=t(uv), host_idx=torch.zeros(F, dtype=i32, device=dev),
                              points_ref=t(p_ref), valid=t(val, torch.bool))
        pyr_imgs = tuple(x.to(f32) for x in ref_rec.pyramid.images)
        tabs = self.vo.aligner.precompute_ref_windows(pyr_imgs, feats, self.camera.fx, self.camera.fy)
        ref = TrackRef(pyr_images=pyr_imgs, T_ref_w=SE3(t(T_ref[:3, :3]), t(T_ref[:3, 3])),
                       ref_slot=t(ref_rec.kf_slot, i32), feats=feats,
                       align_patches=tabs[0], align_J=tabs[1], align_vis=tabs[2])
        prev = sys_.prev_rel
        self.state = VOState(map=m, filt=filt, ref=ref, T_cur_ref=SE3(t(prev[:3, :3]), t(prev[:3, 3])),
                             frame_id=t(sys_.frame_count, i32),
                             failed=torch.zeros((), dtype=torch.bool, device=dev))

    def to_host(self) -> System:
        """Device state → the host ``System`` (for checkpoints, the per-frame
        tail and relocalization). Keyframe pyramids are rebuilt from the
        level-0 images the state holds, as ``System.load_checkpoint`` does."""
        st = self.state
        sys_ = self.host
        a = sys_.arena
        m = st.map

        def n(x, dtype):  # a fresh, writable array: the arena mutates in place
            return x.cpu().numpy().astype(dtype)

        a.kf_valid = n(m.kf_valid, bool)
        pose = np.tile(np.eye(4), (a.max_keyframes, 1, 1))
        pose[:, :3, :3] = n(m.kf_R, np.float64)
        pose[:, :3, 3] = n(m.kf_t, np.float64)
        a.kf_pose = pose
        a.kf_frame_id = n(m.kf_frame_id, np.int64)
        a.kf_counter = int(m.kf_counter)
        a.feat_uv = n(m.feat_uv, np.float64)
        a.feat_point = n(m.feat_point, np.int64)
        a.feat_valid = n(m.feat_valid, bool)
        a.feat_patch = n(m.feat_patch, np.float32)
        a.feat_gx = n(m.feat_gx, np.float32)
        a.feat_gy = n(m.feat_gy, np.float32)
        a.feat_patch_ok = n(m.feat_ok, bool)
        a.pt_pos = n(m.pt_pos, np.float64)
        a.pt_type = n(m.pt_type, np.int32)
        a.pt_valid = n(m.pt_valid, bool)
        a.pt_succeeded = n(m.pt_succ, np.int32)
        a.pt_failed = n(m.pt_fail, np.int32)
        for s in range(a.max_keyframes):
            a.kf_pyramids[s] = (build_pyramid(m.kf_img0[s].to(sys_.dtype), self.scfg.levels)
                                if a.kf_valid[s] else None)
        sys_.filters = st.filt.bank
        sys_.frame_count = int(st.frame_id)
        sys_.trajectory = list(self.trajectory)
        sys_.status = (SystemStatus.RELOCALIZATION if bool(st.failed)
                       else SystemStatus.PROCESS_NEW_FRAME)
        # the reference frame is re-seeded from the device's reference keyframe
        rec = sys_.keyframe_record(int(st.ref.ref_slot))
        sys_.ref_frame = rec
        sys_.last_kf = rec
        T_rel = np.eye(4)
        T_rel[:3, :3] = n(st.T_cur_ref.rotation, np.float64)
        T_rel[:3, 3] = n(st.T_cur_ref.translation, np.float64)
        sys_.prev_rel = T_rel
        return sys_

    # ------------------------------------------------------------------ api
    def add_image(self, image: np.ndarray, timestamp: float = 0.0):
        if self.state is None:
            r = self.host.add_image(np.asarray(image), timestamp)
            self.trajectory.append(None if r == FrameResult.FAILED else self.host.trajectory[-1])
            self.metrics.append(self.host.metrics[-1])
            # (re-)enter the device path once tracking is healthy AND the
            # reference frame is a keyframe: right after relocalization it is a
            # plain tracked frame with no cached patches
            if (self.host.status == SystemStatus.PROCESS_NEW_FRAME
                    and self.host.ref_frame is not None
                    and self.host.ref_frame.kf_slot is not None):
                self._pack()
            return
        self._buffer.append(np.asarray(image, np.float32))
        if len(self._buffer) >= self.supersteps_per_chunk * self.scfg.period:
            self._dispatch(self.supersteps_per_chunk)

    def finish(self):
        """Flush buffered frames (the tail superstep is padded by repeating
        the last frame; padded outputs are dropped). Where a dispatch trips
        relocalization (``state`` drops to None), the frames still buffered
        go through the host ``System``."""
        per = self.scfg.period
        while self.state is not None and len(self._buffer) >= per:
            self._dispatch(len(self._buffer) // per)
        if self.state is not None and self._buffer:
            n_real = len(self._buffer)
            self._buffer += [self._buffer[-1]] * (per - n_real)
            self._dispatch(1, n_real_tail=n_real)
        if self.state is None and self._buffer:
            tail, self._buffer = self._buffer, []
            for img in tail:
                self.add_image(img)
            if self._buffer:  # re-entered the device path mid-tail
                self.finish()

    def _dispatch(self, n_supersteps: int, n_real_tail: Optional[int] = None):
        per = self.scfg.period
        n = n_supersteps * per
        imgs = np.stack(self._buffer[:n]).reshape(n_supersteps, per, *self._buffer[0].shape)
        self._buffer = self._buffer[n:]
        with deterministic_on(self.device):
            self.state, outs = self.vo.run_chunk(self.state, torch.as_tensor(imgs, device=self.device))
        self._emit(FrameOut(*[x.cpu().numpy() for x in outs]),
                   n if n_real_tail is None else (n - per + n_real_tail))
        if bool(self.state.failed):
            self._relocalize()

    def _emit(self, outs: FrameOut, n_emit: int):
        """Append the first ``n_emit`` frames of a chunk's outputs (numpy,
        leading (C, period) axes) to ``trajectory`` and ``metrics``."""
        per = self.scfg.period
        for i in range(n_emit):
            c, p = divmod(i, per)
            ok = bool(outs.ok[c, p])
            T = np.eye(4)
            T[:3, :3] = outs.R[c, p]
            T[:3, 3] = outs.t[c, p]
            self.trajectory.append(T if ok else None)
            self.metrics.append({
                "frame": len(self.trajectory) - 1,
                "result": ("KEYFRAME" if bool(outs.is_kf[c, p]) else "SUCCESS") if ok else "FAILED",
                "n_features": int(outs.n_matches[c, p]), "n_points": int(outs.n_points[c, p]),
                "n_filters": int(outs.n_filters[c, p]), "align_rmse": float(outs.rmse[c, p]),
            })

    def _relocalize(self):
        """At a chunk boundary after a failure: unpack to the host, whose
        ``System`` is then in ``RELOCALIZATION``. The next ``add_image`` calls
        go through it frame by frame; once it is back in ``PROCESS_NEW_FRAME``
        on a keyframe, ``add_image`` re-packs."""
        self.n_relocalizations += 1
        self.to_host()
        self.state = None

    def write_poses(self, path: str):
        write_kitti_poses(path, self.trajectory)

    def save_checkpoint(self, path: str):
        if self.state is not None:
            self.to_host()
        self.host.trajectory = list(self.trajectory)
        self.host.save_checkpoint(path)
