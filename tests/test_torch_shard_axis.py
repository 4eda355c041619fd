"""The port's ``shard`` axis (``sdvo_tpu_torch.parallel``: ``dist_ba``,
``pose_graph``, ``distributed``) on the CPU against the JAX package.

The problems are those of ``test_parallel.py`` / ``test_bundle_adjustment.py``
(a 5-keyframe window of 120 points) and ``test_pose_graph.py`` (a drifted
circle with a loop closure), built from a seed with numpy and carried across
by ``convert.from_numpy``. The JAX side shards over the 8 virtual CPU devices
of ``conftest.py`` (a 2 × 4 mesh); the port puts its 4 shards on
``["cpu"] * 4``. Everything is float64 and held to 1e-8 of the larger of 1
and the array's largest value (points lie up to 30 m away, chi² and the
Hessians are large), except where a test says otherwise.
Two gloo processes, each holding one shard, must give the in-process result.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.geometry import se3 as jse3
from sdvo_tpu.geometry.se3 import SE3 as JSE3
from sdvo_tpu.parallel import dist_ba as jdist
from sdvo_tpu.parallel import pose_graph as jpg
from sdvo_tpu.parallel.mesh import make_vo_mesh as j_make_vo_mesh

from sdvo_tpu_torch.convert import from_numpy, to_numpy
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.parallel import dist_ba, distributed, pose_graph
from sdvo_tpu_torch.parallel.mesh import make_vo_mesh, shard_devices

from test_bundle_adjustment import CX, CY, FX, FY, _window_problem
from test_pose_graph import _make_problem

TOL = 1e-8
K, P, NSH = 5, 120, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(a, b, tol=TOL):
    """|a − b| ≤ tol · max(1, max |b|): absolute for rotations and residuals,
    relative to the largest value for points (≈ 30 m), chi² and Hessians."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * max(float(np.abs(b).max()) if b.size else 0.0, 1.0), (err, float(np.abs(b).max()))


@pytest.fixture(scope="module")
def ba_problem():
    """The window problem of test_parallel, sharded 4 ways by the JAX
    package's ``shard_observations``."""
    _, _, poses_init, pts_init, obs, _ = _window_problem(
        np.random.default_rng(42), noise_px=0.1, pose_noise=0.05, pt_noise=0.1)
    sharded = jdist.shard_observations(np.asarray(obs.cam_idx), np.asarray(obs.pt_idx), np.asarray(obs.uv),
                                       np.asarray(obs.valid), P, NSH, max_obs_per_point=K)
    s_points = sharded[5]
    pts_sharded = np.where((s_points >= 0)[..., None], np.asarray(pts_init)[np.maximum(s_points, 0)], 0.0)
    fixed_cam = np.zeros(K, bool)
    fixed_cam[:2] = True
    return dict(obs=_np(obs), poses=_np(poses_init), pts=pts_sharded, sharded=sharded, fixed=fixed_cam)


def _j_ba_args(pb):
    s_cam, s_pt, s_uv, s_valid, s_table, _ = pb["sharded"]
    return (jnp.asarray(pb["pts"]), jnp.asarray(s_cam), jnp.asarray(s_pt), jnp.asarray(s_uv),
            jnp.asarray(s_valid), jnp.asarray(s_table), jnp.asarray(pb["fixed"]), FX, FY, CX, CY)


def _t_ba_args(pb, shards=None):
    """The port's positional BA arguments; ``shards`` picks a subset (one
    rank's) of the shard axis."""
    s_cam, s_pt, s_uv, s_valid, s_table, _ = pb["sharded"]
    arrays = (pb["pts"], s_cam, s_pt, s_uv, s_valid, s_table)
    if shards is not None:
        arrays = tuple(a[shards] for a in arrays)
    return from_numpy(arrays, "cpu") + (torch.from_numpy(pb["fixed"]), FX, FY, CX, CY)


@pytest.fixture(scope="module")
def jax_ba(ba_problem):
    mesh = j_make_vo_mesh(num_seq=2, num_shard=NSH)
    out = jdist.distributed_local_ba(JSE3(*map(jnp.asarray, ba_problem["poses"])), *_j_ba_args(ba_problem),
                                     mesh=mesh, num_cams=K, iterations=8)
    return _np(out)


def test_shard_observations_equal(ba_problem):
    """The host packing is a copy: every array equal to the JAX package's."""
    o = ba_problem["obs"]
    args = (o.cam_idx, o.pt_idx, o.uv, o.valid, P, 3, K)
    for a, b in zip(dist_ba.shard_observations(*args), jdist.shard_observations(*args)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mesh_shard_axis():
    mesh = make_vo_mesh(num_seq=2, num_shard=4, devices=["cpu"] * 8)
    assert mesh.axis_names == ("seq", "shard") and mesh.devices.shape == (2, 4)
    assert shard_devices(mesh) == [torch.device("cpu")] * 4
    assert dist_ba.payload_floats(16) == 5184  # 20,736 B in float32


def test_distributed_ba_matches_jax(ba_problem, jax_ba):
    """4 port shards on ``["cpu"] * 4`` against the JAX 2 × 4 mesh: poses,
    points, chi² and the undamped reduced camera system."""
    mesh = make_vo_mesh(num_shard=NSH, devices=["cpu"] * NSH)
    poses, pts, chi, S_red = dist_ba.distributed_local_ba(
        from_numpy(ba_problem["poses"], "cpu"), *_t_ba_args(ba_problem), mesh=mesh, num_cams=K, iterations=8)
    j_poses, j_pts, j_chi, j_S = jax_ba
    _close(poses.rotation, j_poses.rotation)
    _close(poses.translation, j_poses.translation)
    _close(pts, j_pts)
    _close(chi, j_chi)
    # the reduced system at the last pre-step state: W·Hpp⁻¹·Wᵀ of points
    # seen from a short baseline with λ down to 1e-12 (Hpp nearly singular in
    # depth), so the 1e-10 relative differences of the iterates grow ~100×
    _close(S_red, j_S, 1e-6)


def _pg_problem(N):
    T_gt, T_init, edges, fixed = _make_problem(np.random.default_rng(42), N)
    return _np(T_gt), _np(T_init), _np(edges), np.asarray(fixed)


@pytest.mark.parametrize("case", ["single", "distributed"])
def test_pose_graph_matches_jax(case):
    """``optimize_pose_graph`` and ``distributed_pose_graph`` (4 edge shards)
    with the loop closure, against the JAX package's; the loop pulls the
    drifted chain's end onto the truth."""
    N = 16
    T_gt, T_init, edges, fixed = _pg_problem(N)
    jT = JSE3(*map(jnp.asarray, T_init))
    jE = jpg.PoseGraphEdges(*map(jnp.asarray, edges))
    tT = from_numpy(T_init, "cpu")
    tE = from_numpy(edges, "cpu")
    if case == "single":
        j_out = jpg.optimize_pose_graph(jT, jE, jnp.asarray(fixed), num_poses=N, iterations=10)
        t_out = pose_graph.optimize_pose_graph(tT, tE, torch.tensor(fixed), num_poses=N, iterations=10)
    else:
        j_out = jpg.distributed_pose_graph(jT, jpg.shard_edges(jE, NSH), jnp.asarray(fixed),
                                           mesh=j_make_vo_mesh(num_seq=2, num_shard=NSH), num_poses=N,
                                           iterations=10)
        t_out = pose_graph.distributed_pose_graph(
            tT, pose_graph.shard_edges(tE, NSH), torch.tensor(fixed),
            mesh=make_vo_mesh(num_shard=NSH, devices=["cpu"] * NSH), num_poses=N, iterations=10)
    (jR, jt), jchi = _np(j_out)
    _close(t_out[0].rotation, jR)
    _close(t_out[0].translation, jt)
    _close(t_out[1], jchi)
    c = lambda R, t: -np.einsum("nji,nj->ni", R, t)  # noqa: E731  camera centres
    end0 = np.linalg.norm(c(*T_init)[-1] - c(*T_gt)[-1])
    end1 = np.linalg.norm(c(*to_numpy(t_out[0]))[-1] - c(*T_gt)[-1])
    assert end1 < 0.5 * end0, (end0, end1)


def test_pose_graph_float32_stalls_as_jax_does():
    """``chip_smoke``'s pose graph (``PG_N`` = 512 keyframes around a 628 m
    loop, ``PG_LOOPS`` = 32 loop edges, ``PG_ITERS`` = 10 LM iterations)
    through both packages' ``optimize_pose_graph`` on the CPU.

    In float64 the two agree to 1e-9 of chi² and 1e-6 m. In float32 both
    stop short of the float64 optimum in the same flat valley: chi² more
    than 1e-3 (relative) above it and poses more than 1 m from its poses,
    while float32 itself resolves that optimum's chi² to 1e-4 (its float32
    evaluation at the rounded float64 poses): the stall is the float32 LM
    steps', in both packages, not the port's. The port's float32 is held to
    JAX's float32 with ``chip_smoke``'s tolerances for a change of float32
    summation order alone (4 edge shards against 1: 0.1 m, 1e-3 of chi²)."""
    import chip_smoke as cs

    prob = cs.pose_graph_problem(seed=1)
    fixed = np.zeros(cs.PG_N, bool)
    fixed[0] = True
    out = {}
    for dt in ("float32", "float64"):
        e = prob["edges"]
        jE = jpg.PoseGraphEdges(jnp.asarray(e[0]), jnp.asarray(e[1]), *(jnp.asarray(a, dt) for a in e[2:5]),
                                jnp.asarray(e[5]))
        jT = JSE3(jnp.asarray(prob["R"], dt), jnp.asarray(prob["t"], dt))
        (jR, jt), jchi = _np(jpg.optimize_pose_graph(jT, jE, jnp.asarray(fixed), num_poses=cs.PG_N,
                                                     iterations=cs.PG_ITERS))
        (tR, tt), tchi = cs.run_pose_graph(prob, 1, "cpu", getattr(torch, dt))
        out[dt] = {"jax": (jR, jt, float(jchi)), "port": (_np(tR), _np(tt), float(tchi))}
    c = lambda R, t: -np.einsum("nji,nj->ni", np.asarray(R, np.float64), np.asarray(t, np.float64))  # noqa: E731
    gap = lambda a, b: float(np.linalg.norm(c(*a[:2]) - c(*b[:2]), axis=-1).max())  # noqa: E731
    j64, t64 = out["float64"]["jax"], out["float64"]["port"]
    assert abs(t64[2] - j64[2]) <= 1e-9 * j64[2] and gap(t64, j64) < 1e-6, (t64[2], j64[2], gap(t64, j64))
    edges32 = pose_graph.PoseGraphEdges(*(torch.from_numpy(np.ascontiguousarray(a)) for a in prob["edges"]))
    edges32 = edges32._replace(R_meas=edges32.R_meas.float(), t_meas=edges32.t_meas.float(),
                               info=edges32.info.float())
    chi64_in32 = float(pose_graph._pg_chi2(torch.from_numpy(j64[0]).float(), torch.from_numpy(j64[1]).float(),
                                           edges32, 5.0))
    assert abs(chi64_in32 - j64[2]) < 1e-4 * j64[2], (chi64_in32, j64[2])
    for pkg in ("jax", "port"):
        r = out["float32"][pkg]
        assert r[2] > (1 + 1e-3) * j64[2] and gap(r, j64) > 1.0, (pkg, r[2], j64[2], gap(r, j64))
    j32, t32 = out["float32"]["jax"], out["float32"]["port"]
    assert abs(t32[2] - j32[2]) < cs.PG_SHARD_CHI_TOL * j32[2], (t32[2], j32[2])
    assert gap(t32, j32) < cs.PG_SHARD_POSE_TOL, gap(t32, j32)


def test_shard_edges_equal():
    """Round-robin edge packing, padded edges with identity rotations, equal
    to the JAX package's."""
    _, _, edges, _ = _pg_problem(16)
    t = to_numpy(pose_graph.shard_edges(from_numpy(edges, "cpu"), 3))
    j = _np(jpg.shard_edges(jpg.PoseGraphEdges(*map(jnp.asarray, edges)), 3))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert np.allclose(t.R_meas[-1, -1], np.eye(3)) and not t.valid[-1, -1]


def _edge_at(rng, theta):
    """An edge whose residual rotates by ``theta`` about a random axis."""
    Ti = jse3.exp(jnp.asarray(rng.normal(0, 0.5, (2, 6))))
    Tj = JSE3(Ti.rotation[1], Ti.translation[1])
    Ti = JSE3(Ti.rotation[0], Ti.translation[0])
    axis = rng.normal(size=3)
    err = jse3.exp(jnp.asarray(np.r_[rng.normal(0, 0.1, 3), theta * axis / np.linalg.norm(axis)]))
    Z = err.inverse().compose(Ti).compose(Tj.inverse())  # r = log(err)
    return [np.asarray(x)[None] for x in (Ti.rotation, Ti.translation, Tj.rotation, Tj.translation,
                                          Z.rotation, Z.translation)]


@pytest.mark.parametrize("theta", [0.0, np.pi - 1e-4], ids=["zero_residual", "near_pi"])
def test_edge_jacobians(theta):
    """``_edge_r_and_J`` by ``torch.func.jacfwd`` under vmap against
    ``jax.jacfwd``: at r = 0 (the odometry edges right after a BA; so3_log's
    small-angle branch) and near π (its near_pi branch). No tangent is NaN.
    Near π the log is ill-conditioned (|dθ/dcos| ~ 1/sin θ ≈ 1e4), so that
    case is held to 1e-6."""
    rng = np.random.default_rng(5)
    if theta == 0.0:
        T = jse3.exp(jnp.asarray(rng.normal(0, 0.3, (2, 6))))
        Z = jse3.relative(JSE3(T.rotation[1], T.translation[1]), JSE3(T.rotation[0], T.translation[0]))
        args = [np.asarray(x)[None] for x in (T.rotation[0], T.translation[0], T.rotation[1],
                                              T.translation[1], Z.rotation, Z.translation)]
    else:
        args = _edge_at(rng, theta)
    r, (A, B) = pose_graph._edge_r_and_J(*[torch.from_numpy(np.array(a)) for a in args])
    jr, (jA, jB) = _np(jax.jit(jpg._edge_r_and_J)(*map(jnp.asarray, args)))
    for x in (r, A, B):
        assert torch.isfinite(x).all()
    tol = TOL if theta == 0.0 else 1e-6
    _close(r, jr, tol)
    _close(A, jA, tol)
    _close(B, jB, tol)
    if theta == 0.0:
        assert float(torch.abs(r).max()) < 1e-12


def test_odometry_edges_and_edge_info():
    rng = np.random.default_rng(0)
    T = jse3.exp(jnp.asarray(rng.normal(0, 0.3, (6, 6))))
    e_t = pose_graph.odometry_edges(from_numpy(_np(T), "cpu"))
    e_j = _np(jpg.odometry_edges(T))
    for a, b in zip(to_numpy(e_t), e_j):
        _close(a, b)
    assert float(pose_graph._pg_chi2(*from_numpy(_np(T), "cpu"), e_t, 5.0)) < 1e-12
    A = rng.normal(size=(24, 24))
    S = A @ A.T + np.eye(24)
    i, j = np.asarray([1, 3], np.int32), np.asarray([0, 2], np.int32)
    lam = pose_graph.edge_info_from_reduced_hessian(torch.from_numpy(S), torch.from_numpy(i), torch.from_numpy(j))
    _close(lam, jpg.edge_info_from_reduced_hessian(jnp.asarray(S), jnp.asarray(i), jnp.asarray(j)))


def test_ba_with_pose_graph_refine(ba_problem):
    """The whole BASELINE config 5 stack on an 8-pose trajectory (3 older
    keyframes before the window), 4 shards, with a loop edge."""
    pre = _np(jse3.exp(jnp.asarray([[-0.6, 0.0, -0.15, 0.0, -0.03, 0.0],
                                    [-0.4, 0.0, -0.10, 0.0, -0.02, 0.0],
                                    [-0.2, 0.0, -0.05, 0.0, -0.01, 0.0]])))
    allp = tuple(np.concatenate([a, b]) for a, b in zip(pre, ba_problem["poses"]))
    R_z = allp[0][7] @ allp[0][0].T  # Z = T_7 ∘ T_0⁻¹ of the initial poses
    loop = (np.asarray([7], np.int32), np.asarray([0], np.int32), R_z[None],
            (allp[1][7] - R_z @ allp[1][0])[None], 5.0 * np.eye(6)[None], np.ones(1, bool))
    j_loop = jpg.PoseGraphEdges(*map(jnp.asarray, loop))
    j_out = jdist.ba_with_pose_graph_refine(
        JSE3(*map(jnp.asarray, allp)), 3, _j_ba_args(ba_problem), loop_edges=j_loop,
        mesh=j_make_vo_mesh(num_seq=2, num_shard=NSH), num_shards=NSH, num_cams=K, iterations=8)
    t_out = dist_ba.ba_with_pose_graph_refine(
        SE3(*from_numpy(allp, "cpu")), 3, _t_ba_args(ba_problem),
        loop_edges=pose_graph.PoseGraphEdges(*from_numpy(loop, "cpu")),
        mesh=make_vo_mesh(num_shard=NSH, devices=["cpu"] * NSH), num_shards=NSH, num_cams=K, iterations=8)
    (jR, jt), j_pts, j_chi_ba, j_chi_pg = _np(j_out)
    _close(t_out[0].rotation, jR)
    _close(t_out[0].translation, jt)
    _close(t_out[1], j_pts)
    _close(t_out[2], j_chi_ba)
    _close(t_out[3], j_chi_pg)


def test_initialize_from_env_without_group(monkeypatch):
    """No environment: a no-op returning False. An environment that names
    a group: the device defaults to the card and, without one, it raises
    (no fallback to gloo or to one process), as does an incomplete one."""
    for k in ("SDVO_COORDINATOR", "SDVO_NUM_PROCESSES", "SDVO_PROCESS_ID", "SDVO_AUTO_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_from_env() is False
    info = distributed.runtime_info()
    assert set(info) == {"process_index", "process_count", "local_devices", "global_devices", "platform"}
    assert info["process_count"] == 1 and info["platform"] == "cpu"
    monkeypatch.setenv("SDVO_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(RuntimeError):
        distributed.initialize_from_env(device="cpu")  # SDVO_NUM_PROCESSES missing
    monkeypatch.setenv("SDVO_NUM_PROCESSES", "1")
    monkeypatch.setenv("SDVO_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize_from_env()


# one rank of the gloo group: its own shard of the 2-shard problem
_RANK = r"""
import pickle, sys, torch
sys.path.insert(0, sys.argv[1])
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.parallel import dist_ba, distributed
pb, rank = pickle.load(open(sys.argv[2], "rb")), int(sys.argv[3])
assert distributed.initialize_from_env(device="cpu")
info = distributed.runtime_info()
s_cam, s_pt, s_uv, s_valid, s_table, _ = pb["sharded"]
mine = [torch.from_numpy(a[rank:rank + 1]) for a in (pb["pts"], s_cam, s_pt, s_uv, s_valid, s_table)]
poses, pts, chi, S_red = dist_ba.distributed_local_ba(
    SE3(*map(torch.from_numpy, pb["poses"])), *mine, torch.from_numpy(pb["fixed"]), *pb["cam"],
    num_cams=pb["K"], iterations=4)
torch.distributed.destroy_process_group()
pickle.dump(dict(info=info, R=poses.rotation.numpy(), t=poses.translation.numpy(), pts=pts.numpy(),
                 chi=chi.numpy(), S=S_red.numpy()), open(sys.argv[4], "wb"))
"""


def test_gloo_two_processes_match_in_process(ba_problem, tmp_path):
    """``initialize_from_env`` with 2 gloo processes, each holding one shard
    of the distributed BA: each rank's result equals the in-process 2-shard
    solve; ``runtime_info`` names the group. Each process runs under a
    timeout of its own."""
    import pickle

    o = ba_problem["obs"]
    sharded = dist_ba.shard_observations(o.cam_idx, o.pt_idx, o.uv, o.valid, P, 2, K)
    s_points = sharded[5]
    pts = np.where((s_points >= 0)[..., None], _unshard(ba_problem)[np.maximum(s_points, 0)], 0.0)
    pb = dict(poses=tuple(ba_problem["poses"]), fixed=ba_problem["fixed"], sharded=sharded, pts=pts,
              cam=(FX, FY, CX, CY), K=K)
    src = tmp_path / "problem.pkl"
    pickle.dump(pb, open(src, "wb"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, SDVO_COORDINATOR=f"127.0.0.1:{port}", SDVO_NUM_PROCESSES="2",
                   SDVO_PROCESS_ID=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK, REPO, str(src), str(rank),
                                       str(tmp_path / f"out{rank}.pkl")], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]

    s_cam, s_pt, s_uv, s_valid, s_table, _ = sharded
    poses, pts_ip, chi, S_red = dist_ba.distributed_local_ba(
        from_numpy(ba_problem["poses"], "cpu"), *from_numpy((pts, s_cam, s_pt, s_uv, s_valid, s_table), "cpu"),
        torch.from_numpy(ba_problem["fixed"]), FX, FY, CX, CY,
        mesh=make_vo_mesh(num_shard=2, devices=["cpu"] * 2), num_cams=K, iterations=4)
    for rank in range(2):
        got = pickle.load(open(tmp_path / f"out{rank}.pkl", "rb"))
        assert got["info"] == {"process_index": rank, "process_count": 2, "local_devices": 1,
                               "global_devices": 2, "platform": "cpu"}, json.dumps(got["info"])
        _close(got["R"], poses.rotation)
        _close(got["t"], poses.translation)
        _close(got["pts"][0], pts_ip[rank])
        _close(got["chi"], chi)
        _close(got["S"], S_red, 1e-6)


def _unshard(pb):
    """The initial points in global order, from the 4-way sharded layout."""
    out = np.zeros((P, 3))
    s_points = pb["sharded"][5]
    ok = s_points >= 0
    out[s_points[ok]] = pb["pts"][ok]
    return out
