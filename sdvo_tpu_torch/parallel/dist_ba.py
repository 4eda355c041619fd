"""Distributed bundle adjustment: landmark blocks sharded over the ``shard``
axis — port of ``sdvo_tpu.parallel.dist_ba`` (``shard_observations``,
``distributed_local_ba``, ``ba_with_pose_graph_refine``; BASELINE config 5).

Each shard holds a block of landmarks with their observations and computes,
from them alone, its partial camera Hessian blocks, Schur fill-in and
right-hand side. One sum over the shards (``distributed.shard_sum``) then
assembles the global reduced camera system (6K × 6K); the dense solve is
replicated and the point back-substitution stays local. The sum runs once
an LM iteration on one flat payload, the packed lower triangle of the
fill-in, the lower triangles of the K camera blocks and the two right-hand
sides (``payload_floats``: 5184 floats at K = 16), and once on the scalar
chi² of the trial step.

The shards of this process lie on the mesh's ``shard_devices`` (all on the
points' device without a mesh) and are summed there in shard order; in a
process group (``distributed.initialize_from_env``) each rank holds its own
shards and the payload is summed over the group by one ``all_reduce``. The
LM's fixed iteration count is a Python loop of ``torch.where`` selects with
no host read; a Cholesky failure (``torch.linalg.cholesky_ex``'s ``info``)
takes a zero step, as the NaN factor of ``jnp.linalg.cholesky`` does in the
reference. On the card the solve runs under PyTorch's deterministic
algorithms (``device.deterministic_on``), so its ``index_add``s sum in a
fixed order.
"""

from __future__ import annotations

import numpy as np
import torch

from sdvo_tpu_torch.ba.bundle_adjustment import _huber_w, _inv3x3, _jacobians, _project_residual
from sdvo_tpu_torch.device import deterministic_on
from sdvo_tpu_torch.geometry import se3
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.parallel.distributed import shard_sum
from sdvo_tpu_torch.parallel.mesh import shard_devices


def shard_observations(
    cam_idx: np.ndarray, pt_idx: np.ndarray, uv: np.ndarray, valid: np.ndarray,
    num_points: int, num_shards: int, max_obs_per_point: int,
):
    """Host-side: partition points (and their observations) into equal-size
    shards, padding each shard to the max sizes. Returns per-shard stacked
    arrays with leading axis ``num_shards`` plus the point permutation.

    Layout: point i (in sorted-unique order) lands on shard ``i % S`` at
    local index ``i // S``; its observations occupy the regular stride
    ``local · max_obs + rank``.
    """
    S = num_shards
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    valid = np.asarray(valid, bool)

    vrows = np.nonzero(valid)[0]
    order = vrows[np.argsort(pt_idx[vrows], kind="stable")]
    pts_sorted = pt_idx[order]
    uniq, starts, counts = np.unique(pts_sorted, return_index=True, return_counts=True)
    n_pts = max(len(uniq), 1)
    P_s = -(-n_pts // S)
    M_s = P_s * max_obs_per_point

    s_cam = np.zeros((S, M_s), np.int32)
    s_new_pt = np.zeros((S, M_s), np.int32)
    s_uv = np.zeros((S, M_s, 2), np.float64)
    s_valid = np.zeros((S, M_s), bool)
    s_table = -np.ones((S, P_s, max_obs_per_point), np.int32)
    s_points = -np.ones((S, P_s), np.int64)
    if len(uniq) == 0:
        return s_cam, s_new_pt, s_uv, s_valid, s_table, s_points

    seq = np.arange(len(uniq))
    shard_of_pt = seq % S
    local_of_pt = seq // S
    s_points[shard_of_pt, local_of_pt] = uniq

    seg_id = np.repeat(seq, counts)  # (n_obs,) unique-point ordinal per obs
    rank = np.arange(len(order)) - np.repeat(starts, counts)
    keep = rank < max_obs_per_point
    r, g, rk = order[keep], seg_id[keep], rank[keep]
    s = shard_of_pt[g]
    lp = local_of_pt[g]
    m = lp * max_obs_per_point + rk
    s_cam[s, m] = cam_idx[r]
    s_new_pt[s, m] = lp
    s_uv[s, m] = uv[r]
    s_valid[s, m] = True
    s_table[s, lp, rk] = m
    return s_cam, s_new_pt, s_uv, s_valid, s_table, s_points


def payload_floats(num_cams: int) -> int:
    """Floats of the reduction an LM iteration sums over the shards: the
    packed lower triangle of the 6K × 6K fill-in, the K camera blocks' lower
    triangles, and the two 6K right-hand sides."""
    n = 6 * num_cams
    return n * (n + 1) // 2 + num_cams * 21 + 2 * n


class _Shard:
    """One landmark block on its device: the observations, and what an LM
    iteration keeps between its linearisation and the back-substitution."""

    def __init__(self, dev, pts, ci, pi, uv, ok, fx, fy, cx, cy, huber_delta):
        self.dev = dev
        self.pts = pts.to(dev)
        self.ci = ci.to(dev).to(torch.int64)
        self.pi = pi.to(dev).to(torch.int64)
        self.uv = uv.to(dev).to(pts.dtype)
        self.ok = ok.to(dev)
        self.cam = (fx, fy, cx, cy)
        self.huber_delta = huber_delta

    def residuals(self, R_all, t_all, pts):
        T = SE3(R_all[self.ci], t_all[self.ci])
        r, z, p_cam = _project_residual(T, pts[self.pi], self.uv, *self.cam)
        live = self.ok & (z > 1e-6)
        return torch.where(live[:, None], r, torch.zeros_like(r)), live, p_cam, T

    def chi2(self, R_all, t_all, pts):
        r, live, _, _ = self.residuals(R_all, t_all, pts)
        w = _huber_w(r, self.huber_delta) * live.to(r.dtype)
        return torch.where(live, w * (r * r).sum(-1), torch.zeros_like(w)).sum()

    def linearize(self, R_all, t_all, lam, free_c, K, tril):
        """This shard's payload at the current state; keeps Hpp⁻¹, the
        fill-in rows and gp for ``back_substitute``."""
        dtype, dev = self.pts.dtype, self.dev
        P_s = self.pts.shape[0]
        r, live, p_cam, T = self.residuals(R_all, t_all, self.pts)
        lf = live.to(dtype)
        w = _huber_w(r, self.huber_delta) * lf
        Jc, Jp = _jacobians(T, p_cam, self.cam[0], self.cam[1])
        Jc = Jc * (free_c[self.ci] * lf)[:, None, None]
        Jp = Jp * lf[:, None, None]
        JcW = Jc * w[:, None, None]
        JpW = Jp * w[:, None, None]
        Hcc = torch.zeros((K, 6, 6), dtype=dtype, device=dev).index_add(
            0, self.ci, torch.einsum("mri,mrj->mij", JcW, Jc))
        gc = torch.zeros((K, 6), dtype=dtype, device=dev).index_add(
            0, self.ci, torch.einsum("mri,mr->mi", JcW, r))
        Hpp = torch.zeros((P_s, 3, 3), dtype=dtype, device=dev).index_add(
            0, self.pi, torch.einsum("mri,mrj->mij", JpW, Jp))
        gp = torch.zeros((P_s, 3), dtype=dtype, device=dev).index_add(
            0, self.pi, torch.einsum("mri,mr->mi", JpW, r))
        Hpp_inv = _inv3x3(Hpp + lam * torch.eye(3, dtype=dtype, device=dev))
        # the Schur fill-in as one local dense product over the shard's points
        Wcp = torch.einsum("mri,mrj->mij", JcW, Jp) * lf[:, None, None]
        Wd = torch.zeros((P_s * K, 6, 3), dtype=dtype, device=dev).index_add(
            0, self.pi * K + self.ci, Wcp).reshape(P_s, K, 6, 3)
        Yd = Wd @ Hpp_inv[:, None]
        Wr = Wd.permute(1, 2, 0, 3).reshape(K * 6, P_s * 3)
        Yr = Yd.permute(1, 2, 0, 3).reshape(K * 6, P_s * 3)
        S_fill = Yr @ Wr.T
        g_fill = Yr @ gp.reshape(P_s * 3)
        self.Hpp_inv, self.Wr, self.gp = Hpp_inv, Wr, gp
        (tl_r, tl_c), (hl_r, hl_c) = tril
        return torch.cat([S_fill[tl_r, tl_c], Hcc[:, hl_r, hl_c].reshape(-1), gc.reshape(-1), g_fill])

    def back_substitute(self, dc):
        K6 = self.Wr.shape[0]
        WTdc = (self.Wr.T @ dc.to(self.dev).reshape(K6)).reshape(-1, 3)
        dp = (self.Hpp_inv * (self.gp - WTdc)[:, None, :]).sum(-1)
        return self.pts - dp


def _symmetric_from_lower(low: torch.Tensor) -> torch.Tensor:
    return low + low.transpose(-1, -2) - torch.diag_embed(torch.diagonal(low, dim1=-2, dim2=-1))


def _with_diag_blocks(S: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """S (6K × 6K) with ``blocks`` (K, 6, 6) added to its diagonal blocks."""
    K = blocks.shape[0]
    ar = torch.arange(K, device=S.device)
    on_diag = (ar[:, None] == ar)[:, None, :, None]
    return (S.reshape(K, 6, K, 6) + torch.where(on_diag, blocks[:, :, None, :], 0.0)).reshape(6 * K, 6 * K)


def distributed_local_ba(
    poses: SE3,  # (K,) replicated
    points: torch.Tensor,  # (S, P_s, 3): this process's shards
    cam_idx: torch.Tensor,  # (S, M_s)
    pt_idx: torch.Tensor,  # (S, M_s) local (within-shard) point index
    uv: torch.Tensor,  # (S, M_s, 2)
    valid: torch.Tensor,  # (S, M_s)
    table: torch.Tensor,  # (S, P_s, Mmax); unused by the solve, as in the reference
    fixed_cam: torch.Tensor,  # (K,)
    fx, fy, cx, cy,
    mesh=None,
    num_cams: int = None,
    iterations: int = 8,
    huber_delta: float = 2.0,
    init_lambda: float = 1e-4,
):
    """Schur-complement LM with landmark shards summed over the ``shard``
    axis: shard s on ``shard_devices(mesh)[s]`` (on the points' device
    without a mesh).

    Returns (poses', points' (S, P_s, 3), total chi², S_reduced), all on
    shard 0's device. ``S_reduced`` is the undamped Schur-reduced camera
    system (6K × 6K) at the last iteration's pre-step state: the marginal
    pose information the pose-graph refine harvests
    (:func:`ba_with_pose_graph_refine`).
    """
    if iterations < 1:
        raise ValueError("distributed_local_ba needs at least one iteration")
    S = points.shape[0]
    devs = shard_devices(mesh) if mesh is not None else [points.device] * S
    if len(devs) != S:
        raise ValueError(f"{S} shards of points for a shard axis of {len(devs)} devices")
    K = poses.translation.shape[0] if num_cams is None else num_cams
    dev0 = devs[0]
    dtype = points.dtype
    tl = torch.tril_indices(K * 6, K * 6, device=dev0)
    hl = torch.tril_indices(6, 6, device=dev0)
    nS, nH = tl.shape[1], K * hl.shape[1]
    with deterministic_on(dev0):
        shards = [_Shard(d, points[s], cam_idx[s], pt_idx[s], uv[s], valid[s], fx, fy, cx, cy,
                         huber_delta) for s, d in enumerate(devs)]
        trils = {d: ((tl[0].to(d), tl[1].to(d)), (hl[0].to(d), hl[1].to(d))) for d in set(devs)}
        free_c = (~fixed_cam.to(dev0)).to(dtype)
        free6 = torch.repeat_interleave(free_c, 6)
        eye6 = torch.eye(6, dtype=dtype, device=dev0)
        R_c, t_c = poses.rotation.to(dev0), poses.translation.to(dev0)
        lam = torch.tensor(init_lambda, dtype=dtype, device=dev0)
        chi = shard_sum([sh.chi2(R_c.to(sh.dev), t_c.to(sh.dev), sh.pts) for sh in shards])
        for _ in range(iterations):
            payload = shard_sum([
                sh.linearize(R_c.to(sh.dev), t_c.to(sh.dev), lam.to(sh.dev), free_c.to(sh.dev), K,
                             trils[sh.dev]) for sh in shards])
            S_low = torch.zeros((K * 6, K * 6), dtype=dtype, device=dev0)
            S_low[tl[0], tl[1]] = payload[:nS]
            S_fill = _symmetric_from_lower(S_low)
            H_low = torch.zeros((K, 6, 6), dtype=dtype, device=dev0)
            H_low[:, hl[0], hl[1]] = payload[nS:nS + nH].reshape(K, -1)
            Hcc = _symmetric_from_lower(H_low)
            gc = payload[nS + nH:nS + nH + K * 6]
            g_fill = payload[nS + nH + K * 6:]

            Sd = _with_diag_blocks(-S_fill, Hcc + lam * eye6)
            Sd = Sd * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
            g_red = (gc - g_fill) * free6
            L, info = torch.linalg.cholesky_ex(Sd + 1e-10 * torch.eye(6 * K, dtype=dtype, device=dev0))
            okc = (info == 0) & torch.isfinite(L).all()
            L = torch.where(okc, L, torch.eye(6 * K, dtype=dtype, device=dev0))
            dc = torch.cholesky_solve(g_red[:, None], L)[:, 0]
            dc = torch.where(okc, dc, torch.zeros_like(dc)).reshape(K, 6)
            pts_new = [sh.back_substitute(dc) for sh in shards]

            delta = se3.exp(-dc)
            R_new = delta.rotation @ R_c
            t_new = torch.einsum("kij,kj->ki", delta.rotation, t_c) + delta.translation
            chi_n = shard_sum([sh.chi2(R_new.to(sh.dev), t_new.to(sh.dev), p)
                               for sh, p in zip(shards, pts_new)])
            better = chi_n < chi
            R_c = torch.where(better, R_new, R_c)
            t_c = torch.where(better, t_new, t_c)
            for sh, p in zip(shards, pts_new):
                sh.pts = torch.where(better.to(sh.dev), p, sh.pts)
            lam = torch.where(better, lam * 0.1, lam * 10.0)
            chi = torch.where(better, chi_n, chi)
            # the UNDAMPED reduced camera system at the pre-step state
            S_und = _with_diag_blocks(-S_fill, Hcc)
        pts_out = torch.stack([sh.pts.to(dev0) for sh in shards])
    return SE3(R_c, t_c), pts_out, chi, S_und


def ba_with_pose_graph_refine(
    poses_all: SE3,  # (N,) the FULL keyframe trajectory (world→camera)
    window_start: int,  # index of the BA window's first keyframe in poses_all
    ba_args: tuple,  # positional args of distributed_local_ba after `poses`
    loop_edges=None,  # optional PoseGraphEdges over trajectory indices
    mesh=None,
    num_shards: int = 1,
    pg_iterations: int = 10,
    **ba_kwargs,
):
    """BASELINE config 5, final stage: windowed distributed Schur BA followed
    by a pose-graph refine over the whole keyframe trajectory.

    The BA's reduced camera system (landmarks marginalized) becomes the
    information of the within-window relative-pose constraints; outside the
    window, plain odometry edges (identity information) chain the remaining
    keyframes; ``loop_edges`` close long-range drift. The refine runs as
    :func:`~sdvo_tpu_torch.parallel.pose_graph.distributed_pose_graph` (edges
    sharded over the mesh) when ``mesh`` is given and ``num_shards`` > 1,
    else as ``optimize_pose_graph``.

    Returns (refined poses (N,), BA points, BA chi², pose-graph chi²).
    """
    from sdvo_tpu_torch.parallel.pose_graph import (
        concat_edges,
        distributed_pose_graph,
        edge_info_from_reduced_hessian,
        odometry_edges,
        optimize_pose_graph,
        shard_edges,
    )

    N = int(poses_all.translation.shape[0])
    window_poses = SE3(poses_all.rotation[window_start:], poses_all.translation[window_start:])
    K = int(window_poses.translation.shape[0])
    ba_kwargs.setdefault("num_cams", K)
    poses_w, pts_out, chi_ba, S_red = distributed_local_ba(window_poses, *ba_args, mesh=mesh, **ba_kwargs)

    # splice the BA-refined window back into the trajectory
    dev = poses_w.translation.device
    R_all = torch.cat([poses_all.rotation[:window_start].to(dev), poses_w.rotation])
    t_all = torch.cat([poses_all.translation[:window_start].to(dev), poses_w.translation])
    poses_new = SE3(R_all, t_all)

    # odometry edges over the whole chain; within-window consecutive edges
    # carry the BA-harvested information, mean-traced to 10× the unit
    # odometry information (BA-backed constraints dominate raw odometry)
    edges = odometry_edges(poses_new)
    iw = torch.arange(K - 1, device=dev)
    lam_w = edge_info_from_reduced_hessian(S_red, iw + 1, iw)
    tr = torch.clamp(torch.diagonal(lam_w, dim1=-2, dim2=-1).sum(-1) / 6.0, min=1e-12)
    lam_w = lam_w / tr[:, None, None] * 10.0
    info = torch.cat([edges.info[:window_start], lam_w, edges.info[window_start + K - 1:]])
    edges = edges._replace(info=info)
    if loop_edges is not None:
        edges = concat_edges(edges, loop_edges)

    fixed = torch.zeros((N,), dtype=torch.bool, device=dev)
    fixed[0] = True
    if mesh is not None and num_shards > 1:
        poses_ref, chi_pg = distributed_pose_graph(
            poses_new, shard_edges(edges, num_shards), fixed, mesh=mesh, num_poses=N,
            iterations=pg_iterations)
    else:
        poses_ref, chi_pg = optimize_pose_graph(poses_new, edges, fixed, num_poses=N,
                                                iterations=pg_iterations)
    return poses_ref, pts_out, chi_ba, chi_pg
