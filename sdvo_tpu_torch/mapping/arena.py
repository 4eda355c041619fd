"""Fixed-capacity map arena: keyframes, landmarks, observations — a numpy copy
of ``sdvo_tpu.mapping.arena.MapArena`` (``PointType`` lives in
``sdvo_tpu_torch.mapping.device_map``).

A bounded struct-of-arrays store on the host: keyframe slots (float64 pose,
the slot's image pyramid on the device, feature tables with the cached
feature-alignment patches), point slots (position, type, projection
counters) and the observations (keyframe slot, feature row → point slot) that
local BA consumes. Slot allocation and eviction are per-keyframe numpy work.

Left out: ``pt_normal``, which the reference writes and never reads, and with
it ``add_point``'s ``observer_center_w`` argument.

``ba_window`` returns numpy arrays in the float64 it is asked for. The
reference asks JAX for float64 too, and gets it only where x64 is enabled
(as under its tests); with x64 off JAX hands back float32 without a word.
The port takes the float64 the code asks for.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from sdvo_tpu_torch.mapping.device_map import PointType


# the arena's arrays: the keys of a checkpoint and of ``convert.arena_to_numpy``
ARENA_KEYS = (
    "kf_valid", "kf_frame_id", "kf_pose", "kf_counter",
    "feat_uv", "feat_point", "feat_valid", "feat_patch", "feat_gx", "feat_gy", "feat_patch_ok",
    "pt_pos", "pt_type", "pt_valid", "pt_succeeded", "pt_failed",
)


class MapArena:
    def __init__(
        self,
        max_keyframes: int = 10,
        max_points: int = 4096,
        max_features_per_kf: int = 256,
        align_patch_size: int = 5,
    ):
        self.max_keyframes = max_keyframes
        self.max_points = max_points
        self.max_features_per_kf = max_features_per_kf
        self.align_patch_size = align_patch_size

        # keyframe slots
        self.kf_valid = np.zeros(max_keyframes, bool)
        self.kf_frame_id = -np.ones(max_keyframes, np.int64)
        self.kf_pose = np.tile(np.eye(4), (max_keyframes, 1, 1))  # world→cam, float64
        self.kf_pyramids: List[Optional[object]] = [None] * max_keyframes
        self.kf_counter = 0  # total keyframes ever added (depth-filter staleness clock)

        # per-KF feature tables
        self.feat_uv = np.zeros((max_keyframes, max_features_per_kf, 2), np.float64)
        self.feat_point = -np.ones((max_keyframes, max_features_per_kf), np.int64)
        self.feat_valid = np.zeros((max_keyframes, max_features_per_kf), bool)
        # cached reference patch (+ gradients) on the host KF's gradient image,
        # extracted ONCE when the observation is created. An observation's uv in
        # its host never moves, so feature alignment can read these tables
        # instead of rebuilding a (K, H·W, P²) shifted stack of every keyframe
        # image each frame (the reference re-interpolates the ref patch per
        # reprojection, src/feature_alignment.cpp:64-110 — pure recompute).
        P2 = align_patch_size * align_patch_size
        self.feat_patch = np.zeros((max_keyframes, max_features_per_kf, P2), np.float32)
        self.feat_gx = np.zeros((max_keyframes, max_features_per_kf, P2), np.float32)
        self.feat_gy = np.zeros((max_keyframes, max_features_per_kf, P2), np.float32)
        self.feat_patch_ok = np.zeros((max_keyframes, max_features_per_kf), bool)

        # point slots
        self.pt_pos = np.zeros((max_points, 3), np.float64)
        self.pt_type = np.full(max_points, int(PointType.UNKNOWN), np.int32)
        self.pt_succeeded = np.zeros(max_points, np.int32)
        self.pt_failed = np.zeros(max_points, np.int32)
        self.pt_valid = np.zeros(max_points, bool)

    # ---- keyframe management ----------------------------------------------
    def num_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def keyframe_slots(self) -> np.ndarray:
        return np.nonzero(self.kf_valid)[0]

    def add_keyframe(self, frame_id: int, pose_wc: np.ndarray, pyramid) -> int:
        """Allocate a slot (Map::addKeyframe, src/map.cpp)."""
        free = np.nonzero(~self.kf_valid)[0]
        if len(free) == 0:
            raise RuntimeError("keyframe arena full — evict first")
        slot = int(free[0])
        self.kf_valid[slot] = True
        self.kf_frame_id[slot] = frame_id
        self.kf_pose[slot] = pose_wc
        self.kf_pyramids[slot] = pyramid
        self.feat_valid[slot] = False
        self.feat_point[slot] = -1
        self.kf_counter += 1
        return slot

    def remove_keyframe(self, slot: int):
        """Removal cascade frame→features→points (src/map.cpp:26-110):
        detach this KF's observations; points that lose all observations are
        deleted."""
        self.kf_valid[slot] = False
        pts = self.feat_point[slot][self.feat_valid[slot]]
        self.feat_valid[slot] = False
        self.feat_point[slot] = -1
        self.kf_pyramids[slot] = None
        for p in pts[pts >= 0]:
            if not self._point_has_observation(int(p)):
                self.remove_point(int(p))

    def _point_has_observation(self, pt: int) -> bool:
        mask = self.feat_valid & (self.feat_point == pt)
        return bool(mask.any())

    def remove_point(self, pt: int):
        self.pt_valid[pt] = False
        self.pt_type[pt] = int(PointType.DELETED)
        sel = self.feat_point == pt
        self.feat_valid[sel & self.feat_valid] = False
        self.feat_point[sel] = -1

    def closest_keyframe(self, position_w: np.ndarray) -> Optional[int]:
        """getClosestKeyframe (src/map.cpp:117-150): nearest camera center."""
        slots = self.keyframe_slots()
        if len(slots) == 0:
            return None
        centers = np.stack([self.camera_center(s) for s in slots])
        d = np.linalg.norm(centers - position_w[None], axis=-1)
        return int(slots[np.argmin(d)])

    def furthest_keyframe(self, position_w: np.ndarray) -> Optional[int]:
        slots = self.keyframe_slots()
        if len(slots) == 0:
            return None
        centers = np.stack([self.camera_center(s) for s in slots])
        d = np.linalg.norm(centers - position_w[None], axis=-1)
        return int(slots[np.argmax(d)])

    def keyframe_by_id(self, frame_id: int) -> Optional[int]:
        hits = np.nonzero(self.kf_valid & (self.kf_frame_id == frame_id))[0]
        return int(hits[0]) if len(hits) else None

    def camera_center(self, slot: int) -> np.ndarray:
        T = self.kf_pose[slot]
        return -T[:3, :3].T @ T[:3, 3]

    # ---- features / points ------------------------------------------------
    def add_features(
        self,
        slot: int,
        uv: np.ndarray,
        point_idx: np.ndarray,
        patch: Optional[np.ndarray] = None,
        gx: Optional[np.ndarray] = None,
        gy: Optional[np.ndarray] = None,
        patch_ok: Optional[np.ndarray] = None,
    ) -> int:
        """Append features to a KF slot; returns how many fit.

        ``patch``/``gx``/``gy`` (n, P²) cache the reference patch + gradients
        sampled from this KF's gradient image at ``uv`` (see the field
        comment); ``patch_ok`` marks patches fully inside the image."""
        free = np.nonzero(~self.feat_valid[slot])[0]
        n = min(len(free), len(uv))
        if n < len(uv):
            # no silent caps: overflowing observations are dropped loudly
            import logging

            logging.getLogger("MapArena").warning(
                "feature table of KF slot %d full: dropping %d/%d new features",
                slot, len(uv) - n, len(uv),
            )
        rows = free[:n]
        self.feat_uv[slot, rows] = uv[:n]
        self.feat_point[slot, rows] = point_idx[:n]
        self.feat_valid[slot, rows] = True
        if patch is not None:
            self.feat_patch[slot, rows] = patch[:n]
            self.feat_gx[slot, rows] = gx[:n]
            self.feat_gy[slot, rows] = gy[:n]
            self.feat_patch_ok[slot, rows] = True if patch_ok is None else patch_ok[:n]
        else:
            self.feat_patch_ok[slot, rows] = False
        return n

    def add_point(
        self,
        pos_w: np.ndarray,
        ptype: PointType = PointType.CANDIDATE,
    ) -> int:
        free = np.nonzero(~self.pt_valid)[0]
        if len(free) == 0:
            # recycle the DELETED pool first, then give up gracefully
            return -1
        slot = int(free[0])
        self.pt_pos[slot] = pos_w
        self.pt_type[slot] = int(ptype)
        self.pt_succeeded[slot] = 0
        self.pt_failed[slot] = 0
        self.pt_valid[slot] = True
        return slot

    def point_observations(self, pt: int) -> List[Tuple[int, int]]:
        """(kf_slot, feat_row) pairs observing a point (Point::m_features)."""
        out = []
        ks, rs = np.nonzero(self.feat_valid & (self.feat_point == pt))
        return list(zip(ks.tolist(), rs.tolist()))

    # ---- global similarity transform (Map::transform, src/map.cpp:200-216) --
    def transform(self, R: np.ndarray, t: np.ndarray, s: float):
        """Apply the similarity world' = s·R·world + t, exactly as the
        reference: camera centers map through the similarity, camera rotations
        pre-multiply by R, point positions map through the similarity."""
        self.pt_pos[self.pt_valid] = (s * (self.pt_pos[self.pt_valid] @ R.T)) + t
        for slot in self.keyframe_slots():
            T = self.kf_pose[slot]
            Rw, tw = T[:3, :3], T[:3, 3]
            center = -Rw.T @ tw
            center_new = s * (R @ center) + t
            # T_cam_world' = (rot, pos).inverse() with rot = R·Rwᵀ... matching
            # the reference: rot_cw = R @ Rw⁻¹ maps world'→? — the reference
            # builds SE3(rot, pos)⁻¹ with rot = R·R_absPoseᵀ and pos = center'
            rot_wc = R @ Rw.T  # camera→world' rotation
            T_new = np.eye(4)
            T_new[:3, :3] = rot_wc.T
            T_new[:3, 3] = -rot_wc.T @ center_new
            self.kf_pose[slot] = T_new

    # ---- BA view ------------------------------------------------------------
    def ba_window(self, dtype=np.float64):
        """Pack the live window into BA inputs (numpy): ``poses_R`` (K, 3, 3),
        ``poses_t`` (K, 3), ``points`` (P, 3), the observation arrays and the
        slot maps."""
        slots = self.keyframe_slots()
        cam_idx, pt_idx, uvs = [], [], []
        # map point slot -> dense index
        live_pts = np.nonzero(self.pt_valid)[0]
        dense_of = -np.ones(self.max_points, np.int64)
        dense_of[live_pts] = np.arange(len(live_pts))
        for ci, s in enumerate(slots):
            rows = np.nonzero(self.feat_valid[s] & (self.feat_point[s] >= 0))[0]
            for r in rows:
                p = self.feat_point[s, r]
                if self.pt_valid[p]:
                    cam_idx.append(ci)
                    pt_idx.append(dense_of[p])
                    uvs.append(self.feat_uv[s, r])
        M = len(cam_idx)
        return {
            "slots": slots,
            "live_pts": live_pts,
            "poses_R": np.asarray(self.kf_pose[slots][:, :3, :3], dtype),
            "poses_t": np.asarray(self.kf_pose[slots][:, :3, 3], dtype),
            "points": np.asarray(self.pt_pos[live_pts], dtype),
            "cam_idx": np.asarray(cam_idx, np.int32),
            "pt_idx": np.asarray(pt_idx, np.int32),
            "uv": np.asarray(uvs, np.float64).reshape(M, 2),
        }
