"""Pipeline orchestration: the per-frame ``System`` state machine — port of
``sdvo_tpu.pipeline.system`` (``SystemStatus``, ``FrameResult``,
``_FrameRecord``, ``System``).

First frame / second frame (two-view bootstrap) / new frame / relocalization,
constant-velocity pose prediction, the tracking-quality gate, a keyframe
every Nth frame, a sliding window of keyframes with furthest-keyframe
eviction, KITTI pose output and checkpoints.

The host owns the state machine, the float64 pose chain and the arena
bookkeeping (numpy); every tensor stage of a frame runs on ``device``:
pyramid build, sparse image alignment (K1, four launches), map reprojection
with feature alignment (K2), the bearing-residual pose polish
(``optimize_pose``, the portable LM, as in the reference), the depth-filter
update (K4) and, on keyframes, windowed Schur BA in float64. Each stage ends
in a host read, as the reference's does. ``device`` defaults to the CUDA card
and raises where there is none; ``device="cpu"`` asks for the CPU, where the
kernels' wrappers take their plain versions. On the card a frame's stages
run with PyTorch's deterministic algorithms (``device.deterministic_on``),
since the float64 bundle adjustment's ``index_add``s would otherwise sum by
atomic adds in a new order every run.

The two-view bootstrap runs once a sequence, on the CPU in float64 (the pose
chain's dtype). ``ransac_uniforms`` (S, N), when given, replace the RANSAC
draws of the first bootstrap attempt (N = the first frame's detections);
later draws come from a ``torch.Generator`` seeded with ``seed``.

Checkpoints are the ``.npz`` of the reference's ``save_checkpoint`` (same
keys, shapes and dtypes): either package loads the other's.

``config.visualization`` turns on the per-stage overlays (``_viz_dump``:
"File" writes PNGs under ``<output_dir>/images``, "LiveShow" shows them in a
matplotlib window and falls back to "File" on a headless display) and the
optimizer diagnostics: a ``viz.diagnostics.FileDiagnosticsSink`` under
``<output_dir>/diagnostics`` takes each alignment level's and each pose
polish's residuals, weights and JᵀWJ (tags ``image_alignment`` and
``pose_refine``). Off by default; then nothing is written or read back.
"""

from __future__ import annotations

import enum
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sdvo_tpu_torch.align.image_alignment import AlignFeatures, SparseImageAlign
from sdvo_tpu_torch.ba.bundle_adjustment import (
    BAObservations,
    BASettings,
    local_ba,
    optimize_pose,
    pose_covariance,
)
from sdvo_tpu_torch.config import Config
from sdvo_tpu_torch.dataio.poses import write_kitti_poses
from sdvo_tpu_torch.depth.filter import FilterBank, init_filters, update_filters
from sdvo_tpu_torch.device import deterministic_on, resolve_device
from sdvo_tpu_torch.features.detection import FeatureSelection
from sdvo_tpu_torch.geometry.camera import PinholeCamera, build_undistort_maps
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.interp import bilinear_sample, extract_patches, padded_patch_and_gradients
from sdvo_tpu_torch.image.pyramid import ImagePyramid, build_pyramid
from sdvo_tpu_torch.mapping.arena import ARENA_KEYS, MapArena
from sdvo_tpu_torch.mapping.device_map import PointType
from sdvo_tpu_torch.mapping.reproject import reproject_map
from sdvo_tpu_torch.optim.optimizer import LMSettings
from sdvo_tpu_torch.pipeline.bootstrap import bootstrap_two_view
from sdvo_tpu_torch.utils.logging import get_logger
from sdvo_tpu_torch.utils.timing import Timers


class SystemStatus(enum.Enum):
    PROCESS_FIRST_FRAME = 0
    PROCESS_SECOND_FRAME = 1
    PROCESS_NEW_FRAME = 2
    RELOCALIZATION = 3


class FrameResult(enum.Enum):
    SUCCESS = 0
    KEYFRAME = 1
    FAILED = 2


class _FrameRecord:
    """Host-side per-frame record; the pyramid lives on the device."""

    def __init__(self, frame_id, timestamp, pyramid, pose_wc):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.pyramid = pyramid  # ImagePyramid on the device
        self.pose_wc = pose_wc  # 4x4 float64 numpy, world→camera
        self.pose_cov = np.zeros((6, 6))
        self.feat_uv = np.zeros((0, 2))
        self.feat_point = np.zeros((0,), np.int64)  # arena point slots (−1 = none)
        self.kf_slot: Optional[int] = None


def _pose44(T: SE3) -> np.ndarray:
    """A device SE3 as a float64 4×4 with its rotation re-orthonormalised by
    SVD on the host (the float32 drift guard)."""
    out = np.eye(4)
    out[:3, :3] = T.rotation.cpu().numpy().astype(np.float64)
    out[:3, 3] = T.translation.cpu().numpy().astype(np.float64)
    U, _, Vt = np.linalg.svd(out[:3, :3])
    out[:3, :3] = U @ Vt
    return out


class System:
    def __init__(self, config: Config, camera: Optional[PinholeCamera] = None, seed: int = 0,
                 device=None, ransac_uniforms: Optional[np.ndarray] = None):
        self.config = config
        self.device = resolve_device(device)
        cfg_a = config.algorithm
        self.log = get_logger("System")
        self.timers = Timers("system.")
        self.dtype = torch.float32 if config.compute_dtype == "float32" else torch.float64
        self._np_dtype = np.float32 if self.dtype == torch.float32 else np.float64

        if camera is None:
            camera = PinholeCamera.create(721.5377, 721.5377, 609.5593, 172.854,
                                          config.camera.img_width, config.camera.img_height,
                                          dtype=self.dtype)
        else:
            # intrinsics rounded to the compute dtype, whatever the caller's
            camera = PinholeCamera.create(camera.fx, camera.fy, camera.cx, camera.cy, camera.width,
                                          camera.height, dist=camera.dist, dtype=self.dtype)
        self.camera = camera
        self.width = camera.width
        self.height = camera.height

        self.status = SystemStatus.PROCESS_FIRST_FRAME
        self.arena = MapArena(
            max_keyframes=cfg_a.max_keyframes + 3,
            max_points=cfg_a.max_points,
            max_features_per_kf=cfg_a.max_features_per_frame,
        )
        self.arena.intrinsics = (camera.fx, camera.fy, camera.cx, camera.cy)
        self.selector = FeatureSelection(self.width, self.height, cfg_a.cell_pixel_size)
        # the class defaults: 12 iterations a level, no taper, frozen ESM
        align_settings = SparseImageAlign.DEFAULT_SETTINGS
        self.pose_settings = None  # optimize_pose's defaults
        if config.visualization.enable_visualization:
            # the optimizer diagnostics of every alignment level and pose polish
            from sdvo_tpu_torch.viz.diagnostics import FileDiagnosticsSink

            FileDiagnosticsSink(os.path.join(config.file_paths.output_dir, "diagnostics")).install()
            align_settings = align_settings._replace(visualize=True, viz_tag="image_alignment")
            self.pose_settings = LMSettings(max_iterations=15, visualize=True, viz_tag="pose_refine")
        self.aligner = SparseImageAlign(
            patch_size=cfg_a.patch_size_image_alignment,
            min_level=cfg_a.min_level_image_pyramid,
            max_level=cfg_a.max_level_image_pyramid,
            settings=align_settings,
        )
        self.num_levels = cfg_a.max_level_image_pyramid + 1

        self.filter_patch = 7  # the epipolar matcher's patch
        self.filters = FilterBank.empty(cfg_a.max_filters, self.filter_patch ** 2, self.dtype,
                                        device=self.device)

        self.ref_frame: Optional[_FrameRecord] = None
        self.last_kf: Optional[_FrameRecord] = None
        self.prev_rel = np.eye(4)  # constant-velocity model T_cur_prev
        self.frame_count = 0
        self.trajectory: List[Optional[np.ndarray]] = []  # per input frame, 4x4 world→cam or None
        self.metrics: List[Dict] = []
        self.np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator().manual_seed(seed)
        self.ransac_uniforms = ransac_uniforms
        self.pose_refinement = True  # bearing-vector pose polish after reprojection
        self.n_local_ba = 0  # keyframes on which the windowed BA solved

        # distortion at ingest: every incoming image is remapped so that the
        # whole pipeline runs on the pinhole model
        self._undistort_maps = build_undistort_maps(camera) if camera.has_distortion else None

    # ------------------------------------------------------------------ api
    def add_image(self, image: np.ndarray, timestamp: float) -> FrameResult:
        """Per-frame entry point."""
        t0 = time.perf_counter()
        if image.ndim != 2:
            raise ValueError("grayscale input required")
        image = self.preprocess_image(image)
        img = torch.as_tensor(np.asarray(image, self._np_dtype), device=self.device)
        with self.timers.scope("pyramid"):
            pyramid = build_pyramid(img, self.num_levels)
        frame = _FrameRecord(self.frame_count, timestamp, pyramid, np.eye(4))
        self.frame_count += 1

        with deterministic_on(self.device):  # local_ba's float index_adds, on the card
            if self.status == SystemStatus.PROCESS_FIRST_FRAME:
                result = self._process_first_frame(frame)
            elif self.status == SystemStatus.PROCESS_SECOND_FRAME:
                result = self._process_second_frame(frame)
            elif self.status == SystemStatus.PROCESS_NEW_FRAME:
                result = self._process_new_frame(frame)
            else:
                result = self._relocalize_frame(frame)

        self.trajectory.append(None if result == FrameResult.FAILED else frame.pose_wc.copy())
        self.metrics.append(
            {
                "frame": frame.frame_id,
                "result": result.name,
                "n_features": len(frame.feat_uv),
                "n_keyframes": self.arena.num_keyframes(),
                "n_points": int(self.arena.pt_valid.sum()),
                "n_filters": int(self.filters.valid.sum()),
                "wall_ms": (time.perf_counter() - t0) * 1e3,
            }
        )
        return result

    def preprocess_image(self, image: np.ndarray) -> np.ndarray:
        """Undistort at ingest when the camera model has distortion."""
        if self._undistort_maps is None:
            return image
        from scipy.ndimage import map_coordinates

        map_u, map_v = self._undistort_maps
        return map_coordinates(
            np.asarray(image, np.float32), [map_v, map_u], order=1, mode="nearest"
        )

    def _viz_dump(self, frame: _FrameRecord, stage: str, uv: np.ndarray, color="orange"):
        """Per-stage overlay, gated by config.visualization: saving_type
        "File" writes a PNG, "LiveShow" shows it in a matplotlib window (the
        cv::imshow analog) and falls back to "File" on a headless display."""
        cfg_v = self.config.visualization
        if not cfg_v.enable_visualization or cfg_v.saving_type not in ("File", "LiveShow"):
            return

        from sdvo_tpu_torch.viz.overlays import draw_feature_points, get_color_image

        img = frame.pyramid.base_image.cpu().numpy().astype(np.uint8)
        over = draw_feature_points(get_color_image(img), np.asarray(uv), color=color)
        if cfg_v.saving_type == "LiveShow":
            try:
                import matplotlib.pyplot as plt

                if not hasattr(self, "_live_fig"):
                    plt.ion()
                    self._live_fig, self._live_ax = plt.subplots(num="sdvo-tpu")
                    self._live_im = self._live_ax.imshow(over)
                else:
                    self._live_im.set_data(over)
                self._live_ax.set_title(f"frame {frame.frame_id}: {stage}")
                self._live_fig.canvas.draw_idle()
                plt.pause(0.001)
            except Exception as e:  # headless display
                self.log.warning("LiveShow unavailable (%s); falling back to File", e)
                self.config = self.config.replace(
                    visualization=cfg_v.__class__(enable_visualization=True, saving_type="File"))
                self._viz_dump(frame, stage, uv, color)
            return
        out_dir = os.path.join(self.config.file_paths.output_dir, "images")
        os.makedirs(out_dir, exist_ok=True)
        from PIL import Image

        Image.fromarray(over).save(os.path.join(out_dir, f"{frame.frame_id:06d}_{stage}.png"))

    def write_poses(self, path: str):
        write_kitti_poses(path, self.trajectory)

    def report_summary(self) -> str:
        """Keyframe/point/filter tables."""
        a = self.arena
        lines = ["=== system summary ==="]
        lines.append(f"status: {self.status.name}, frames: {self.frame_count}")
        lines.append(
            f"keyframes: {a.num_keyframes()}, points: {int(a.pt_valid.sum())} "
            f"(good {int(((a.pt_type == int(PointType.GOOD)) & a.pt_valid).sum())}, "
            f"candidate {int(((a.pt_type == int(PointType.CANDIDATE)) & a.pt_valid).sum())}), "
            f"filters: {int(self.filters.valid.sum())}"
        )
        lines.append("kf_slot  frame_id  n_features  n_with_points")
        for s in a.keyframe_slots():
            nf = int(a.feat_valid[s].sum())
            nwp = int((a.feat_valid[s] & (a.feat_point[s] >= 0)).sum())
            lines.append(f"{s:7d} {int(a.kf_frame_id[s]):9d} {nf:11d} {nwp:14d}")
        return "\n".join(lines)

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, path: str):
        """Serialize the full tracker state (map arena, filter bank,
        trajectory, status) to a .npz; resume = reload + continue."""
        a = self.arena
        filt = {f"filt_{k}": v.cpu().numpy() for k, v in self.filters._asdict().items()}
        traj = (np.stack([np.full((4, 4), np.nan) if T is None else T for T in self.trajectory])
                if self.trajectory else np.zeros((0, 4, 4)))
        # level-0 keyframe images: the pyramids are rebuilt from these on load
        kf_img0 = np.zeros((a.max_keyframes, self.height, self.width), np.float32)
        for s in a.keyframe_slots():
            if a.kf_pyramids[s] is not None:
                kf_img0[s] = a.kf_pyramids[s].base_image.cpu().numpy().astype(np.float32)
        np.savez_compressed(
            path,
            status=self.status.value,
            kf_img0=kf_img0,
            frame_count=self.frame_count,
            prev_rel=self.prev_rel,
            trajectory=traj,
            **{k: getattr(a, k) for k in ARENA_KEYS},
            **filt,
        )

    def load_checkpoint(self, path: str):
        """Restore a state saved by ``save_checkpoint`` and re-arm tracking:
        keyframe pyramids are rebuilt from the stored level-0 images and the
        tracking reference is re-seeded from the newest restored keyframe, so
        the next ``add_image`` tracks photometrically. The constant-velocity
        seed becomes the last tracked pose relative to that keyframe."""
        z = np.load(path)
        a = self.arena
        self.status = SystemStatus(int(z["status"]))
        self.frame_count = int(z["frame_count"])
        self.prev_rel = z["prev_rel"]
        for k in ARENA_KEYS:
            if k in z.files:  # a checkpoint from before the patch tables lacks them
                setattr(a, k, int(z[k]) if k == "kf_counter" else z[k])
        self.trajectory = [None if np.any(np.isnan(T)) else T for T in z["trajectory"]]
        self.filters = FilterBank(**{k[5:]: torch.as_tensor(z[k], device=self.device)
                                     for k in z.files if k.startswith("filt_")})

        if "kf_img0" in z.files:
            for s in a.keyframe_slots():
                a.kf_pyramids[s] = self._pyramid_of(z["kf_img0"][s])

        # re-seed the tracking reference from the newest keyframe
        self.ref_frame = None
        self.last_kf = None
        slots = a.keyframe_slots()
        if len(slots) and a.kf_pyramids[slots[0]] is not None:
            rec = self.keyframe_record(int(slots[np.argmax(a.kf_frame_id[slots])]))
            self.ref_frame = rec
            self.last_kf = rec
            # where the newest keyframe IS the last tracked frame, the saved
            # constant-velocity delta is already the right seed
            if rec.frame_id != self.frame_count - 1:
                last_T = next((T for T in reversed(self.trajectory) if T is not None), None)
                self.prev_rel = (
                    last_T @ np.linalg.inv(rec.pose_wc) if last_T is not None else np.eye(4)
                )
        elif self.status in (SystemStatus.PROCESS_NEW_FRAME, SystemStatus.RELOCALIZATION,
                             SystemStatus.PROCESS_SECOND_FRAME):
            # no usable keyframe imagery: restart tracking from scratch, keeping
            # the restored trajectory and frame counter
            self.status = SystemStatus.PROCESS_FIRST_FRAME

    def _pyramid_of(self, image0: np.ndarray) -> ImagePyramid:
        return build_pyramid(torch.as_tensor(np.asarray(image0, self._np_dtype), device=self.device),
                             self.num_levels)

    def keyframe_record(self, slot: int) -> _FrameRecord:
        """The frame record of an arena keyframe: its pose, pyramid and the
        features that observe a point."""
        a = self.arena
        rec = _FrameRecord(int(a.kf_frame_id[slot]), 0.0, a.kf_pyramids[slot], a.kf_pose[slot].copy())
        rows = np.nonzero(a.feat_valid[slot] & (a.feat_point[slot] >= 0))[0]
        rec.feat_uv = a.feat_uv[slot, rows].copy()
        rec.feat_point = a.feat_point[slot, rows].copy()
        rec.kf_slot = slot
        return rec

    # ------------------------------------------------------- state handlers
    def _detect(self, frame: _FrameRecord):
        cfg_i = self.config.initialization
        return self.selector.detect_with_ssc(
            frame.pyramid.base_gradient.cpu().numpy(), cfg_i.threshold_gradient_magnitude,
            cfg_i.desired_detected_points)

    def _process_first_frame(self, frame: _FrameRecord) -> FrameResult:
        """Detect features, make the first keyframe."""
        cfg = self.config
        self.selector.reset_grid()
        feats = self._detect(frame)
        if len(feats.uv) < cfg.initialization.min_detected_points:
            self.log.warning("first frame: only %d features", len(feats.uv))
            return FrameResult.FAILED
        frame.pose_wc = np.eye(4)
        frame.feat_uv = feats.uv.astype(np.float64)
        frame.feat_point = -np.ones(len(feats.uv), np.int64)
        self._viz_dump(frame, "detect", feats.uv, color="green")
        frame.kf_slot = self.arena.add_keyframe(frame.frame_id, frame.pose_wc, frame.pyramid)
        self.ref_frame = frame
        self.last_kf = frame
        self.status = SystemStatus.PROCESS_SECOND_FRAME
        return FrameResult.KEYFRAME

    def _process_second_frame(self, frame: _FrameRecord) -> FrameResult:
        """Two-frame bootstrap."""
        cfg_i = self.config.initialization
        cpu = torch.device("cpu")
        pyr_cpu = lambda p: ImagePyramid(tuple(x.to(cpu) for x in p.images), ())  # noqa: E731
        uniforms, self.ransac_uniforms = self.ransac_uniforms, None
        with self.timers.scope("bootstrap"):
            res = bootstrap_two_view(
                pyr_cpu(self.ref_frame.pyramid), pyr_cpu(frame.pyramid),
                torch.as_tensor(self.ref_frame.feat_uv), self.camera,
                uniforms=None if uniforms is None else torch.tensor(np.asarray(uniforms)),
                generator=self.generator,
                min_disparity=cfg_i.disparity_threshold,
                min_inliers=cfg_i.min_detected_points // 2,
                map_scale_factor=cfg_i.map_scale_factor,
                klt_window=cfg_i.patch_size_optical_flow,
                ransac_hypotheses=cfg_i.ransac_hypotheses,
                ransac_threshold_px=cfg_i.ransac_threshold_px,
            )
        if not res.success:
            self.log.warning("bootstrap failed: %s", res.reason)
            return FrameResult.FAILED

        frame.pose_wc = res.T_cur_ref @ self.ref_frame.pose_wc

        # create points + features in both frames
        n = len(res.points_w)
        pt_slots = np.empty(n, np.int64)
        for i in range(n):
            pt_slots[i] = self.arena.add_point(res.points_w[i], PointType.GOOD)
        ok = pt_slots >= 0
        self._add_features_cached(
            self.ref_frame.kf_slot, self.ref_frame.pyramid, res.uv_ref[ok], pt_slots[ok]
        )
        # the reference frame's pre-bootstrap features are replaced
        self.ref_frame.feat_uv = res.uv_ref[ok]
        self.ref_frame.feat_point = pt_slots[ok]

        frame.feat_uv = res.uv_cur[ok]
        frame.feat_point = pt_slots[ok]
        frame.kf_slot = self.arena.add_keyframe(frame.frame_id, frame.pose_wc, frame.pyramid)
        self._add_features_cached(frame.kf_slot, frame.pyramid, res.uv_cur[ok], pt_slots[ok])

        # redetect fresh features avoiding the existing ones
        self._redetect_and_seed_filters(frame, res.median_depth, 0.5 * res.min_depth)

        self.last_kf = frame
        self.ref_frame = frame
        self.prev_rel = res.T_cur_ref
        self.status = SystemStatus.PROCESS_NEW_FRAME
        self.log.info(
            "bootstrap ok: %d points, median depth %.2f", int(ok.sum()), res.median_depth
        )
        return FrameResult.KEYFRAME

    def _process_new_frame(self, frame: _FrameRecord) -> FrameResult:
        """Steady-state tracking."""
        cfg = self.config
        ref = self.ref_frame
        lastkf = self.last_kf

        # 1. constant-velocity prediction
        T_pred_rel = self.prev_rel.copy()

        # 2. sparse image alignment vs the reference frame (+ last keyframe features)
        T_rel, align_rmse = self._sparse_align(frame, T_pred_rel)
        frame.pose_wc = T_rel @ ref.pose_wc

        # 3. map reprojection + batched feature alignment
        with self.timers.scope("reproject"):
            rep = self._reproject(frame)

        # 4. pose polish on matched features (bearing residuals)
        if self.pose_refinement and len(rep.pt_slot) >= 10:
            with self.timers.scope("pose_refine"):
                self._refine_pose(frame, rep)

        # 5. tracking quality gate
        n_obs = len(rep.pt_slot)
        ref_obs = int((ref.feat_point >= 0).sum())
        if n_obs < cfg.algorithm.min_tracked_features or (ref_obs - n_obs) > cfg.algorithm.max_dropped_features:
            self.log.warning("tracking quality failed: %d obs (ref %d)", n_obs, ref_obs)
            frame.pose_wc = ref.pose_wc.copy()  # freeze pose
            self.status = SystemStatus.RELOCALIZATION
            return FrameResult.FAILED

        frame.feat_uv = rep.uv
        frame.feat_point = rep.pt_slot
        self._viz_dump(frame, "reproject", rep.uv)

        # 6. scene depth stats in the current frame
        pts_cam = self._points_in_frame(frame)
        depth_mean = float(np.median(pts_cam[:, 2])) if len(pts_cam) else 1.0
        depth_min = float(np.min(pts_cam[:, 2])) if len(pts_cam) else 0.1

        # 7. keyframe decision: every Nth frame
        diff_id = frame.frame_id - lastkf.frame_id
        is_kf = diff_id >= cfg.algorithm.keyframe_every_n

        # 8. depth-filter bank update, inline
        with self.timers.scope("depth_filters"):
            self._update_depth_filters(frame)

        if not is_kf:
            self.ref_frame = frame
            self.prev_rel = T_rel
            return FrameResult.SUCCESS

        # --- keyframe path --------------------------------------------------
        frame.kf_slot = self.arena.add_keyframe(frame.frame_id, frame.pose_wc, frame.pyramid)
        self._add_features_cached(frame.kf_slot, frame.pyramid, frame.feat_uv, frame.feat_point)

        with self.timers.scope("local_ba"):
            self._run_local_ba(frame)

        self._redetect_and_seed_filters(frame, depth_mean, 0.5 * depth_min)

        # sliding window eviction
        if self.arena.num_keyframes() > cfg.algorithm.max_keyframes:
            center = self.arena.camera_center(frame.kf_slot)
            far = self.arena.furthest_keyframe(center)
            if far is not None and far != frame.kf_slot:
                self._drop_filters_of_kf(far)
                self.arena.remove_keyframe(far)

        self.last_kf = frame
        self.ref_frame = frame
        self.prev_rel = T_rel
        return FrameResult.KEYFRAME

    def _relocalize_frame(self, frame: _FrameRecord) -> FrameResult:
        """Align against the nearest usable keyframe; resume on success."""
        if self.ref_frame is None:
            return FrameResult.FAILED
        center = -self.ref_frame.pose_wc[:3, :3].T @ self.ref_frame.pose_wc[:3, 3]
        # nearest keyframe that is usable (enough live observations and imagery)
        slots = self.arena.keyframe_slots()
        if len(slots) == 0:
            return FrameResult.FAILED
        centers = np.stack([self.arena.camera_center(s) for s in slots])
        order = np.argsort(np.linalg.norm(centers - center[None], axis=-1))
        slot = None
        for s in slots[order]:
            r = np.nonzero(self.arena.feat_valid[s] & (self.arena.feat_point[s] >= 0))[0]
            if len(r) >= 20 and self.arena.kf_pyramids[s] is not None:
                slot = int(s)
                break
        if slot is None:
            return FrameResult.FAILED
        kf_rec = self.keyframe_record(slot)
        saved_ref, saved_kf = self.ref_frame, self.last_kf
        self.ref_frame = kf_rec
        self.last_kf = kf_rec
        T_rel, rmse = self._sparse_align(frame, np.eye(4))
        if float(rmse) < 80.0:
            frame.pose_wc = T_rel @ kf_rec.pose_wc
            self.prev_rel = np.eye(4)
            self.ref_frame = frame
            rep = self._reproject(frame)
            if len(rep.pt_slot) >= 30:
                frame.feat_uv = rep.uv
                frame.feat_point = rep.pt_slot
                self.status = SystemStatus.PROCESS_NEW_FRAME
                return FrameResult.SUCCESS
        self.ref_frame, self.last_kf = saved_ref, saved_kf
        return FrameResult.FAILED

    # ------------------------------------------------------------- helpers
    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype or self.dtype)

    def _se3(self, T44: np.ndarray) -> SE3:
        return SE3(self._tensor(T44[:3, :3]), self._tensor(T44[:3, 3]))

    def _sparse_align(self, frame: _FrameRecord, T_pred_rel: np.ndarray):
        """Build the batched feature set (reference frame + last keyframe
        features) and run the coarse-to-fine alignment."""
        ref = self.ref_frame
        lastkf = self.last_kf
        cap = 2 * self.config.algorithm.max_features_per_frame

        uv = np.zeros((cap, 2), self._np_dtype)
        host = np.zeros(cap, np.int32)
        pref = np.zeros((cap, 3), self._np_dtype)
        pref[:, 2] = 1.0
        val = np.zeros(cap, bool)
        T_ref_w = ref.pose_wc

        n = 0
        for host_idx, rec in ((0, ref), (1, lastkf)):
            if rec is None:
                continue
            sel = rec.feat_point >= 0
            uvs = rec.feat_uv[sel]
            pts = rec.feat_point[sel]
            live = self.arena.pt_valid[pts]
            uvs, pts = uvs[live], pts[live]
            k = min(len(uvs), cap - n)
            if k <= 0 or (host_idx == 1 and rec is ref):
                continue
            p_w = self.arena.pt_pos[pts[:k]]
            p_ref = (T_ref_w[:3, :3] @ p_w.T).T + T_ref_w[:3, 3]
            uv[n : n + k] = uvs[:k]
            host[n : n + k] = host_idx
            pref[n : n + k] = p_ref
            val[n : n + k] = p_ref[:, 2] > 1e-3
            n += k

        feats = AlignFeatures(
            uv_host=self._tensor(uv), host_idx=self._tensor(host, torch.int32),
            points_ref=self._tensor(pref), valid=self._tensor(val, torch.bool),
        )
        # both host pyramids already lie on the device: hand over the two
        # images of each level as they are
        kf_pyr = lastkf.pyramid if lastkf is not None else ref.pyramid
        host_pyr = [(ref.pyramid.images[lvl], kf_pyr.images[lvl]) for lvl in range(self.num_levels)]

        cam = self.camera
        with self.timers.scope("image_align"):
            T_est, rmse, _ = self.aligner.align(
                self._se3(T_pred_rel), host_pyr, frame.pyramid.images, feats,
                cam.fx, cam.fy, cam.cx, cam.cy,
            )
            T_rel = _pose44(T_est)
        return T_rel, rmse

    def _reproject(self, frame: _FrameRecord):
        cfg_a = self.config.algorithm
        return reproject_map(
            self._se3(frame.pose_wc), frame.pyramid.base_gradient, self.arena,
            cell_size=cfg_a.cell_pixel_size,
            max_matches=cfg_a.max_reprojection_matches,
            max_error=cfg_a.feature_alignment_max_error,
            patch_size=cfg_a.patch_size_feature_alignment,
            rng=self.np_rng,
        )

    def _patch_tables(self, pyramid, uv: np.ndarray):
        """Reference patch + gradients on a keyframe's gradient image for new
        observations (cached in the arena)."""
        patch, gx, gy, ok = padded_patch_and_gradients(
            lambda q: bilinear_sample(pyramid.base_gradient, q), self._tensor(uv).reshape(-1, 2),
            self.config.algorithm.patch_size_feature_alignment,
        )
        f32 = np.float32
        return (patch.cpu().numpy().astype(f32), gx.cpu().numpy().astype(f32),
                gy.cpu().numpy().astype(f32), ok.cpu().numpy())

    def _add_features_cached(self, slot: int, pyramid, uv: np.ndarray, point_idx: np.ndarray):
        patch, gx, gy, ok = self._patch_tables(pyramid, uv)
        return self.arena.add_features(slot, uv, point_idx, patch, gx, gy, ok)

    def _refine_pose(self, frame: _FrameRecord, rep):
        pts_w = self._tensor(self.arena.pt_pos[rep.pt_slot])
        bearings = self.camera.backproject(self._tensor(rep.uv))
        valid = torch.ones((len(rep.pt_slot),), dtype=torch.bool, device=self.device)
        T_out, _, _ = optimize_pose(self._se3(frame.pose_wc), pts_w, bearings, valid,
                                    settings=self.pose_settings)
        frame.pose_cov = pose_covariance(T_out, pts_w, bearings, valid).cpu().numpy().astype(np.float64)
        frame.pose_wc = _pose44(T_out)

    def _points_in_frame(self, frame: _FrameRecord) -> np.ndarray:
        sel = frame.feat_point >= 0
        pts = frame.feat_point[sel]
        pts = pts[self.arena.pt_valid[pts]]
        if len(pts) == 0:
            return np.zeros((0, 3))
        p_w = self.arena.pt_pos[pts]
        T = frame.pose_wc
        return (T[:3, :3] @ p_w.T).T + T[:3, 3]

    def _run_local_ba(self, frame: _FrameRecord):
        """Windowed BA over all arena keyframes in float64; the two oldest
        stay fixed (gauge). Observations with chi² over 5.991 are pruned."""
        pack = self.arena.ba_window(dtype=np.float64)
        K = len(pack["slots"])
        P = pack["points"].shape[0]
        M = len(pack["cam_idx"])
        if K < 3 or P < 10 or M < 20:
            return
        order = np.argsort(self.arena.kf_frame_id[pack["slots"]])
        fixed = np.zeros(K, bool)
        fixed[order[:2]] = True
        f64 = torch.float64
        dev = self.device
        cam = self.camera
        poses_out, pts_out, chi2_obs, _ = local_ba(
            SE3(self._tensor(pack["poses_R"], f64), self._tensor(pack["poses_t"], f64)),
            self._tensor(pack["points"], f64),
            BAObservations(
                self._tensor(pack["cam_idx"], torch.int64), self._tensor(pack["pt_idx"], torch.int64),
                self._tensor(pack["uv"], f64), torch.ones((M,), dtype=torch.bool, device=dev),
            ),
            self._tensor(fixed, torch.bool), torch.zeros((P,), dtype=torch.bool, device=dev),
            cam.fx, cam.fy, cam.cx, cam.cy,
            settings=BASettings(
                iterations=8, huber_delta=2.0,
                structure_presolve=self.config.algorithm.ba_structure_presolve,
            ),
        )
        self.n_local_ba += 1
        # write back poses/points
        poses_np_R = poses_out.rotation.cpu().numpy()
        poses_np_t = poses_out.translation.cpu().numpy()
        for i, s in enumerate(pack["slots"]):
            T = np.eye(4)
            T[:3, :3] = poses_np_R[i]
            T[:3, 3] = poses_np_t[i]
            self.arena.kf_pose[s] = T
        self.arena.pt_pos[pack["live_pts"]] = pts_out.cpu().numpy()
        # chi² pruning of observations
        bad = chi2_obs.cpu().numpy() > 5.991
        cam_idx = pack["cam_idx"]
        pt_idx = pack["pt_idx"]
        live_pts = pack["live_pts"]
        for m in np.nonzero(bad)[0]:
            s = pack["slots"][cam_idx[m]]
            p = live_pts[pt_idx[m]]
            rows = np.nonzero(self.arena.feat_valid[s] & (self.arena.feat_point[s] == p))[0]
            self.arena.feat_valid[s, rows] = False
            self.arena.feat_point[s, rows] = -1
            if not self.arena._point_has_observation(int(p)):
                self.arena.remove_point(int(p))
        # keep the tracked frame's pose in sync with its keyframe slot
        if frame.kf_slot is not None:
            frame.pose_wc = self.arena.kf_pose[frame.kf_slot].copy()

    def _redetect_and_seed_filters(self, frame: _FrameRecord, depth_mean: float, depth_min: float):
        """Feature redetection on a new keyframe + depth-filter seeding."""
        self.selector.reset_grid()
        self.selector.set_existing_features(frame.feat_uv)
        det = self._detect(frame)
        if len(det.uv) == 0:
            return
        uv_new = self._tensor(det.uv)
        patches, p_ok = extract_patches(frame.pyramid.base_image, uv_new, self.filter_patch)
        new_bank = init_filters(
            uv_new, self.camera.backproject(uv_new), patches, kf_slot=frame.kf_slot,
            depth_mean=max(depth_mean, 1e-3), depth_min=max(depth_min, 1e-4),
            kf_counter=self.arena.kf_counter, new_valid=p_ok, dtype=self.dtype,
        )
        self._insert_filters(new_bank)

    def _insert_filters(self, new_bank: FilterBank):
        """Copy the new filters into the first free bank slots, on the device."""
        free = torch.nonzero(~self.filters.valid)[:, 0]
        src = torch.nonzero(new_bank.valid)[:, 0]
        n = min(free.shape[0], src.shape[0])
        if n == 0:
            return
        self.filters = FilterBank(*[old.index_copy(0, free[:n], new[src[:n]].to(old.dtype))
                                    for old, new in zip(self.filters, new_bank)])

    def _drop_filters_of_kf(self, slot: int):
        self.filters = self.filters._replace(
            valid=self.filters.valid & (self.filters.kf_slot != slot))

    def _update_depth_filters(self, frame: _FrameRecord):
        """Batched filter-bank update; converged filters become CANDIDATE
        points with an observation in their host keyframe."""
        cfg_a = self.config.algorithm
        valid_np = self.filters.valid.cpu().numpy()
        if valid_np.sum() == 0:
            return
        # per-filter relative pose host keyframe → current frame (host f64 math)
        kf_slots = self.filters.kf_slot.cpu().numpy()
        T_cur = frame.pose_wc
        R = np.zeros((len(kf_slots), 3, 3))
        t = np.zeros((len(kf_slots), 3))
        for s in np.unique(kf_slots[valid_np]):
            T_kf = self.arena.kf_pose[s] if self.arena.kf_valid[s] else np.eye(4)
            T_rel = T_cur @ np.linalg.inv(T_kf)
            sel = kf_slots == s
            R[sel] = T_rel[:3, :3]
            t[sel] = T_rel[:3, 3]
        cam = self.camera
        bank, converged = update_filters(
            self.filters, SE3(self._tensor(R), self._tensor(t)), frame.pyramid.base_image,
            cam.fx, cam.fy, cam.cx, cam.cy,
            kf_counter=self.arena.kf_counter,
            patch_size=self.filter_patch,
            num_steps=cfg_a.epipolar_search_steps,
            staleness=cfg_a.filter_staleness_keyframes,
            convergence_factor=cfg_a.filter_convergence_sigma_factor,
        )
        self.filters = bank
        conv_np = np.nonzero(converged.cpu().numpy())[0]
        if len(conv_np) == 0:
            return
        mu = bank.mu.cpu().numpy()
        uv_ref = bank.uv_ref.cpu().numpy()
        bearing = bank.bearing_ref.cpu().numpy()
        by_slot: Dict[int, List[int]] = {}
        for i in conv_np:
            s = int(kf_slots[i])
            if self.arena.kf_valid[s]:
                by_slot.setdefault(s, []).append(int(i))
        for s, idxs in by_slot.items():
            T_kf = self.arena.kf_pose[s]
            new_pts, new_uvs = [], []
            for i in idxs:
                depth = 1.0 / max(float(mu[i]), 1e-9)
                p_kf = bearing[i] * depth
                p_w = T_kf[:3, :3].T @ (p_kf - T_kf[:3, 3])
                pt = self.arena.add_point(p_w, PointType.CANDIDATE)
                if pt >= 0:
                    new_pts.append(pt)
                    new_uvs.append(uv_ref[i])
            if not new_pts:
                continue
            pyr = self.arena.kf_pyramids[s]
            if pyr is not None:
                self._add_features_cached(
                    s, pyr, np.asarray(new_uvs), np.asarray(new_pts, np.int64)
                )
            else:
                self.arena.add_features(s, np.asarray(new_uvs), np.asarray(new_pts, np.int64))
