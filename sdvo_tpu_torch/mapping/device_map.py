"""Device-resident map arena — port of ``sdvo_tpu.mapping.device_map``
(``DeviceMap``, ``DeviceMatches``, ``reproject_device``,
``orphan_point_cleanup``, ``evict_furthest_keyframe``, ``alloc_free_slots``)
and ``PointType`` from ``sdvo_tpu.mapping.arena``.

Everything is fixed-shape masked tensor code with no host synchronisation:
per-segment winners by ``scatter_reduce(amax)`` of unique int32 keys,
repeated-index counters by ``index_add``, and the capacity caps by a stable
descending sort (``topk_stable``), which resolves ties to the lower index as
``jax.lax.top_k`` does. The cell-shuffle hash keeps the reference's int32
wraparound.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import torch

from sdvo_tpu_torch.align.feature_alignment import align_features_2d_cached
from sdvo_tpu_torch.geometry.essential import topk_stable
from sdvo_tpu_torch.geometry.se3 import SE3

INT32_MIN = -(2 ** 31)
_HASH_MUL = 2654435761 & 0x7FFFFFFF
_SALT_MUL = 40503


class PointType(enum.IntEnum):
    UNKNOWN = 0
    CANDIDATE = 1
    GOOD = 2
    DELETED = 3


class DeviceMap(NamedTuple):
    """Fixed-capacity SoA map: K keyframe slots, F features each, P points."""

    kf_R: torch.Tensor  # (K, 3, 3) world→camera rotation
    kf_t: torch.Tensor  # (K, 3)
    kf_valid: torch.Tensor  # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) int32
    kf_counter: torch.Tensor  # () int32 — keyframes ever added
    kf_img0: torch.Tensor  # (K, H, W) level-0 keyframe images
    feat_uv: torch.Tensor  # (K, F, 2)
    feat_point: torch.Tensor  # (K, F) int32 point slot, -1 = none
    feat_valid: torch.Tensor  # (K, F) bool
    feat_patch: torch.Tensor  # (K, F, P2) cached patch on the host gradient image
    feat_gx: torch.Tensor  # (K, F, P2)
    feat_gy: torch.Tensor  # (K, F, P2)
    feat_ok: torch.Tensor  # (K, F) bool
    pt_pos: torch.Tensor  # (P, 3)
    pt_type: torch.Tensor  # (P,) int32 PointType
    pt_valid: torch.Tensor  # (P,) bool
    pt_succ: torch.Tensor  # (P,) int32
    pt_fail: torch.Tensor  # (P,) int32

    def kf_pose(self) -> SE3:
        return SE3(self.kf_R, self.kf_t)

    def kf_centers(self) -> torch.Tensor:
        return -torch.einsum("kji,kj->ki", self.kf_R, self.kf_t)


class DeviceMatches(NamedTuple):
    pt_slot: torch.Tensor  # (M,) int64 point slot (clipped; gate on `good`)
    uv: torch.Tensor  # (M, 2)
    err: torch.Tensor  # (M,)
    good: torch.Tensor  # (M,) bool
    n_good: torch.Tensor  # () int32


def _scatter_argmax(key: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """True where ``key`` is its segment's maximum (keys unique per segment)."""
    best = torch.full((num_segments,), INT32_MIN, dtype=torch.int32, device=key.device)
    best = best.scatter_reduce(0, seg, key, reduce="amax", include_self=True)
    return key == best[seg]


def _cell_index(x: torch.Tensor, cell_size: int, n: int) -> torch.Tensor:
    """clip(int32(x / cell), 0, n-1), with the float clamped first so values
    out of int32 range convert the same on every backend."""
    q = torch.clamp(x / cell_size, -1.0, float(n)).to(torch.int32)
    return torch.clamp(q, 0, n - 1)


def reproject_device(m: DeviceMap, T_cur_w: SE3, cur_gradient: torch.Tensor,
                     fx: float, fy: float, cx: float, cy: float, cell_size: int,
                     max_matches: int, max_error: float, patch_size: int,
                     frame_salt: torch.Tensor) -> Tuple[DeviceMap, DeviceMatches]:
    """One full reprojection pass (Map::reprojectMap) over the arena."""
    K, F = m.feat_valid.shape
    P = m.pt_pos.shape[0]
    KF = K * F
    H, W = cur_gradient.shape
    border = 8.0
    dtype = m.pt_pos.dtype
    dev = m.pt_pos.device
    GOOD, CAND = int(PointType.GOOD), int(PointType.CANDIDATE)

    pt = m.feat_point.reshape(KF)
    pt_c = torch.clamp(pt, 0, P - 1).to(torch.int64)
    ptype = m.pt_type[pt_c]
    obs_valid = (m.feat_valid.reshape(KF) & (pt >= 0) & m.pt_valid[pt_c] & m.feat_ok.reshape(KF)
                 & ((ptype == GOOD) | (ptype == CAND)))

    pos = m.pt_pos[pt_c]
    p_cam = T_cur_w.apply(pos)
    z = p_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * p_cam[..., 0] / z_safe + cx
    v = fy * p_cam[..., 1] / z_safe + cy
    vis = obs_valid & (z > 1e-6) & (u >= border) & (v >= border) & (u < W - border) & (v < H - border)
    pt_fail = m.pt_fail.index_add(0, pt_c, (obs_valid & ~vis).to(torch.int32))

    # close-view observation selection (60 deg cutoff)
    cur_center = -torch.einsum("ji,j->i", T_cur_w.rotation, T_cur_w.translation)
    dir_cur = cur_center[None] - pos
    dir_cur = dir_cur / torch.clamp(torch.linalg.norm(dir_cur, dim=-1, keepdim=True), min=1e-12)
    obs_center = torch.repeat_interleave(m.kf_centers(), F, dim=0)
    dir_obs = obs_center - pos
    dir_obs = dir_obs / torch.clamp(torch.linalg.norm(dir_obs, dim=-1, keepdim=True), min=1e-12)
    cos_view = torch.sum(dir_cur * dir_obs, dim=-1)
    usable = vis & (cos_view > 0.5)

    idx = torch.arange(KF, dtype=torch.int32, device=dev)
    int_min = torch.full_like(idx, INT32_MIN)
    ckey = (torch.clamp(cos_view, 0.0, 1.0) * 16384.0).to(torch.int32)
    ckey = torch.where(usable, ckey * KF + idx, int_min)
    winner = usable & _scatter_argmax(ckey, pt_c, P)

    # grid binning: one candidate per cell, GOOD preferred, hashed tie-break
    gc = (W + cell_size - 1) // cell_size
    gr = (H + cell_size - 1) // cell_size
    cell = (_cell_index(v, cell_size, gr) * gc + _cell_index(u, cell_size, gc)).to(torch.int64)
    quality = (ptype == GOOD).to(torch.int32)
    salt = frame_salt.to(torch.int32) * _SALT_MUL
    h = ((idx * _HASH_MUL) ^ salt) & 1023
    gkey = torch.where(winner, (quality * 2048 + h) * KF + idx, int_min)
    cell_win = winner & _scatter_argmax(gkey, cell, gr * gc)

    # cap to max_matches, shuffled preference
    prio = torch.where(cell_win, (quality * 2048 + h).to(dtype), torch.full_like(u, -1.0))
    topv, sel = topk_stable(prio, max_matches)
    live = topv >= 0.0
    kf_of = sel // F
    row_of = sel % F
    uv_init = torch.stack([u[sel], v[sel]], dim=-1)
    uv_out, err, conv = align_features_2d_cached(
        cur_gradient, m.feat_patch[kf_of, row_of], m.feat_gx[kf_of, row_of],
        m.feat_gy[kf_of, row_of], uv_init.to(dtype), live, patch_size=patch_size,
    )
    good = live & conv & (err < max_error)

    # quality counters + promote / kill
    sel_pt = pt_c[sel]
    pt_succ = m.pt_succ.index_add(0, sel_pt, good.to(torch.int32))
    pt_fail = pt_fail.index_add(0, sel_pt, (live & ~good).to(torch.int32))
    promote = (pt_succ >= 3) & (m.pt_type == CAND) & m.pt_valid
    pt_type = torch.where(promote, torch.full_like(m.pt_type, GOOD), m.pt_type)
    kill = (pt_fail > 15) & (pt_fail > 3 * torch.clamp(pt_succ, min=1)) & m.pt_valid
    pt_valid = m.pt_valid & ~kill
    pt_type = torch.where(kill, torch.full_like(pt_type, int(PointType.DELETED)), pt_type)
    feat_killed = kill[torch.clamp(m.feat_point, 0, P - 1).to(torch.int64)] & (m.feat_point >= 0)
    m_out = m._replace(pt_succ=pt_succ, pt_fail=pt_fail, pt_type=pt_type, pt_valid=pt_valid,
                       feat_valid=m.feat_valid & ~feat_killed)
    matches = DeviceMatches(pt_slot=sel_pt, uv=uv_out, err=err, good=good,
                            n_good=good.to(torch.int32).sum().to(torch.int32))
    return m_out, matches


def orphan_point_cleanup(m: DeviceMap) -> DeviceMap:
    """Invalidate points that lost every observation."""
    P = m.pt_pos.shape[0]
    fp = m.feat_point.reshape(-1)
    pt = torch.clamp(fp, 0, P - 1).to(torch.int64)
    cnt = torch.zeros((P,), dtype=torch.int32, device=fp.device).index_add(
        0, pt, (m.feat_valid.reshape(-1) & (fp >= 0)).to(torch.int32))
    gone = m.pt_valid & (cnt == 0)
    return m._replace(pt_valid=m.pt_valid & ~gone,
                      pt_type=torch.where(gone, torch.full_like(m.pt_type, int(PointType.DELETED)),
                                          m.pt_type))


def evict_furthest_keyframe(m: DeviceMap, keep_slot: torch.Tensor, max_keyframes: int):
    """When more than ``max_keyframes`` are live, drop the keyframe furthest
    from ``keep_slot``'s centre. Returns (map', evicted slot or -1)."""
    K = m.kf_valid.shape[0]
    centers = m.kf_centers()
    ref_center = centers.index_select(0, keep_slot.reshape(1).to(torch.int64))
    d = torch.linalg.norm(centers - ref_center, dim=-1)
    ar = torch.arange(K, device=d.device)
    cand = m.kf_valid & (ar != keep_slot)
    d = torch.where(cand, d, torch.full_like(d, -1.0))
    evict = torch.argmax(d).to(torch.int32)
    need = m.kf_valid.to(torch.int32).sum() > max_keyframes
    hit = need & (ar == evict)
    m = m._replace(kf_valid=m.kf_valid & ~hit, feat_valid=m.feat_valid & ~hit[:, None])
    return orphan_point_cleanup(m), torch.where(need, evict, torch.full_like(evict, -1))


def alloc_free_slots(valid: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First ``n`` free slots of a validity mask, lowest index first.
    Returns (slots (n,) int64, ok (n,) bool)."""
    k = min(n, valid.shape[0])
    val, slots = topk_stable((~valid).to(torch.int32), k)
    if k < n:
        slots = torch.cat([slots, slots.new_zeros(n - k)])
        val = torch.cat([val, val.new_zeros(n - k)])
    return slots, val > 0
