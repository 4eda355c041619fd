"""The port's per-frame host path against the JAX package on the CPU:
``SparseImageAlign.align`` with two hosts, ``MapArena``, ``reproject_map``,
the host ``System`` end to end (with a blackout and the recovery from it),
``DeviceSystem``'s fall-back to the host (``to_host``, ``_relocalize``,
``_pack``), checkpoints across the two packages and the port's CLI.

Scene: the 320×240 ridge sequence of ``test_pipeline_e2e.make_sequence`` with
the configuration of ``test_torch_device_system``; both packages bootstrap
with the same RANSAC uniforms.

Two semantics meet on the CPU: the JAX ``System`` picks its XLA branches
there, the port follows the kernels (their plain versions). So the module
tests build the JAX side on the kernels — ``SparseImageAlign(backend=
"pallas")`` in interpret mode, and ``align_features_2d_cached`` patched to
``backend="pallas"`` inside ``reproject_map`` for the test — and the
end-to-end tests hold the two ``System``s to a band: the same result per
frame, camera centres within 2 % of the path. Tolerances are stated per test.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import sdvo_tpu.mapping.reproject as j_reproject_mod
from sdvo_tpu.align.image_alignment import AlignFeatures as JAlignFeatures
from sdvo_tpu.align.image_alignment import SparseImageAlign as JSparseImageAlign
from sdvo_tpu.config import load_config as j_load_config
from sdvo_tpu.geometry.camera import PinholeCamera as JCamera
from sdvo_tpu.geometry.se3 import SE3 as JSE3
from sdvo_tpu.mapping.arena import MapArena as JMapArena
from sdvo_tpu.mapping.arena import PointType as JPointType
from sdvo_tpu.pipeline.device_system import DeviceSystem as JDeviceSystem
from sdvo_tpu.pipeline.system import System as JSystem

from sdvo_tpu_torch import main as cli
from sdvo_tpu_torch.align.image_alignment import AlignFeatures, SparseImageAlign
from sdvo_tpu_torch.config import load_config
from sdvo_tpu_torch.convert import arena_from_numpy, arena_to_numpy, to_numpy
from sdvo_tpu_torch.geometry.camera import PinholeCamera, build_undistort_maps
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.pyramid import build_pyramid
from sdvo_tpu_torch.mapping.arena import ARENA_KEYS, MapArena
from sdvo_tpu_torch.mapping.device_map import PointType
from sdvo_tpu_torch.mapping.reproject import reproject_map
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem
from sdvo_tpu_torch.pipeline.system import System, SystemStatus

from test_pipeline_e2e import CAM, make_sequence
from test_torch_device_system import KW, OVERRIDES
from test_torch_modules import _np, _plane_images, _t

torch.set_num_threads(2)

N_FRAMES = 14
BLACKOUT_AT = 8  # the host scenario: 8 frames, 3 black ones, the rest
SNAPSHOT_AT = 6  # the arena before this frame feeds the reproject_map test
CHECKPOINT_AT = 8  # checkpoints of both Systems after this many frames


def _centers(traj):
    return np.asarray([-T[:3, :3].T @ T[:3, 3] for T in traj])


def _results(system):
    return [m["result"] for m in system.metrics]


@pytest.fixture(scope="module")
def frames():
    _, images, poses = make_sequence(np.random.default_rng(7), n_frames=N_FRAMES)
    return [np.asarray(im, np.float64) for im in images], poses


def _uniforms(jsys):
    """The RANSAC draws of the JAX System's first bootstrap attempt."""
    n_feat = len(jsys.ref_frame.feat_uv)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    return np.asarray(jax.random.uniform(sub, (256, n_feat), dtype=jnp.float64))


@pytest.fixture(scope="module")
def host_runs(frames, tmp_path_factory):
    """Both ``System``s over: 8 frames, a blackout of 3, 6 more. On the way:
    the JAX arena and the next frame before frame 6, and a checkpoint of each
    after frame 7."""
    images, poses = frames
    black = np.zeros_like(images[0])
    seq = images[:BLACKOUT_AT] + [black] * 3 + images[BLACKOUT_AT:]
    tmp = tmp_path_factory.mktemp("ckpt")
    jsys = JSystem(j_load_config(overrides=OVERRIDES), camera=JCamera.create(**CAM, dtype=jnp.float64))
    jsys.add_image(seq[0], 0.0)
    tsys = System(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM), device="cpu",
                  ransac_uniforms=_uniforms(jsys))
    tsys.add_image(seq[0], 0.0)
    extra = {}
    for i, im in enumerate(seq[1:], start=1):
        if i == SNAPSHOT_AT:
            extra["arena"] = arena_to_numpy(jsys.arena)
        if i == CHECKPOINT_AT:
            extra["ckpt"] = (str(tmp / "jax.npz"), str(tmp / "torch.npz"))
            jsys.save_checkpoint(extra["ckpt"][0])
            tsys.save_checkpoint(extra["ckpt"][1])
        jsys.add_image(im, float(i))
        tsys.add_image(im, float(i))
    return jsys, tsys, seq, extra


# ------------------------------------------------------------ the System
def test_system_results_match_frame_by_frame(host_runs):
    """The same result string for every frame: bootstrap, a keyframe every
    third frame, three FAILED frames in the blackout, recovery on the first
    textured frame after it and keyframes again."""
    jsys, tsys, seq, _ = host_runs
    assert _results(tsys) == _results(jsys)
    res = _results(tsys)
    assert res[:2] == ["KEYFRAME", "KEYFRAME"]
    assert res[BLACKOUT_AT:BLACKOUT_AT + 3] == ["FAILED"] * 3
    assert "FAILED" not in res[:BLACKOUT_AT] and "FAILED" not in res[BLACKOUT_AT + 3:]
    assert res[BLACKOUT_AT + 3] == "SUCCESS" and "KEYFRAME" in res[BLACKOUT_AT + 4:]
    assert [T is None for T in tsys.trajectory] == [r == "FAILED" for r in res]
    assert tsys.status == SystemStatus.PROCESS_NEW_FRAME
    assert tsys.n_local_ba >= 2  # the windowed BA solved on keyframes


def test_system_trajectory_within_band(host_runs):
    """Camera centres within 2 % of the path length of the JAX run, before
    and after the relocalization (XLA-vs-kernel semantics, as in
    ``test_two_supersteps_track_like_reference``); the same number of
    matches a frame up to the blackout, map sizes within 5 %."""
    jsys, tsys, _, _ = host_runs
    ok = [i for i, T in enumerate(jsys.trajectory) if T is not None]
    cj = _centers([jsys.trajectory[i] for i in ok])
    ct = _centers([tsys.trajectory[i] for i in ok])
    path = float(np.sum(np.linalg.norm(np.diff(cj, axis=0), axis=-1)))
    err = np.linalg.norm(ct - cj, axis=-1).max()
    assert err < 0.02 * path, (err, path)
    for key in ("n_features", "n_points", "n_filters", "n_keyframes"):
        jv = np.array([m[key] for m in jsys.metrics], float)
        tv = np.array([m[key] for m in tsys.metrics], float)
        np.testing.assert_array_equal(tv[:BLACKOUT_AT], jv[:BLACKOUT_AT], err_msg=key)
        np.testing.assert_allclose(tv, jv, rtol=0.05, atol=3, err_msg=key)


def test_system_arena_matches_before_blackout(host_runs):
    """The checkpoints taken after 8 frames: the arenas agree mask for mask
    and slot for slot; poses, positions and filter means to what the two
    alignments leave (the scene's median depth is 1)."""
    _, _, _, extra = host_runs
    zj, zt = (np.load(p) for p in extra["ckpt"])
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].shape == zt[k].shape and zj[k].dtype == zt[k].dtype, k
    for k in ("status", "frame_count", "kf_valid", "kf_frame_id", "kf_counter", "feat_point",
              "feat_valid", "feat_patch_ok", "pt_type", "pt_valid", "pt_succeeded", "pt_failed",
              "filt_valid", "filt_kf_slot", "filt_born_kf", "kf_img0"):
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    np.testing.assert_allclose(zt["kf_pose"], zj["kf_pose"], atol=1e-3)
    # points: all but a few to 5e-3; a depth filter that converged one frame
    # apart leaves its candidate up to 0.05 away along its ray
    d_pt = np.abs(zt["pt_pos"] - zj["pt_pos"]).max(-1)
    assert d_pt.max() < 0.05 and (d_pt > 5e-3).mean() < 0.01, (d_pt.max(), (d_pt > 5e-3).sum())
    np.testing.assert_allclose(zt["feat_uv"], zj["feat_uv"], atol=0.1)
    np.testing.assert_allclose(zt["filt_mu"], zj["filt_mu"], rtol=0.05)


def test_checkpoints_cross_load(host_runs, frames):
    """An ``.npz`` written by either package loads into the other's
    ``System``, which then tracks three more frames with the results the
    uninterrupted run gave."""
    extra = host_runs[3]
    images, _ = frames
    jpath, tpath = extra["ckpt"]
    fresh_t = System(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM), device="cpu")
    fresh_t.load_checkpoint(jpath)
    fresh_j = JSystem(j_load_config(overrides=OVERRIDES), camera=JCamera.create(**CAM, dtype=jnp.float64))
    fresh_j.load_checkpoint(tpath)
    for fresh in (fresh_t, fresh_j):
        assert fresh.status.name == "PROCESS_NEW_FRAME" and fresh.frame_count == CHECKPOINT_AT
        assert fresh.ref_frame.kf_slot is not None and len(fresh.trajectory) == CHECKPOINT_AT
    zj = np.load(jpath)
    for k in ARENA_KEYS:
        np.testing.assert_array_equal(getattr(fresh_t.arena, k), zj[k], err_msg=k)
    for k, v in fresh_t.filters._asdict().items():
        np.testing.assert_array_equal(_np(v), zj["filt_" + k], err_msg=k)
    zt = np.load(tpath)
    for k in ARENA_KEYS:
        np.testing.assert_array_equal(getattr(fresh_j.arena, k), zt[k], err_msg=k)
    # the textured frames that follow the checkpoint in the sequence without a blackout
    for i, im in enumerate(images[CHECKPOINT_AT:CHECKPOINT_AT + 3], start=CHECKPOINT_AT):
        rt = fresh_t.add_image(im, float(i))
        rj = fresh_j.add_image(im, float(i))
        assert rt.name == rj.name != "FAILED"
    assert [m["result"] for m in fresh_t.metrics] == ["SUCCESS", "SUCCESS", "KEYFRAME"]
    ct, cj = _centers(fresh_t.trajectory[-3:]), _centers(fresh_j.trajectory[-3:])
    assert np.linalg.norm(ct - cj, axis=-1).max() < 2e-3


def test_system_refuses_visualization(tmp_path):
    """Named for the time the port refused a configuration with
    visualization; it now wires it as the JAX ``System`` does: a
    ``FileDiagnosticsSink`` under ``<output_dir>/diagnostics`` and the
    alignment's and the pose polish's settings with ``visualize`` on and
    their tags. The default configuration wires none of it."""
    from sdvo_tpu_torch.optim import optimizer as topt
    from sdvo_tpu_torch.viz.diagnostics import FileDiagnosticsSink

    cfg = load_config(overrides={**OVERRIDES, "visualization": {"enable_visualization": True},
                                 "file_paths": {"output_dir": str(tmp_path)}})
    try:
        tsys = System(cfg, camera=PinholeCamera.create(**CAM), device="cpu")
        assert isinstance(topt._DIAGNOSTICS_SINK, FileDiagnosticsSink)
        assert topt._DIAGNOSTICS_SINK.out_dir == os.path.join(str(tmp_path), "diagnostics")
    finally:
        topt.set_diagnostics_sink(None)
    assert (tsys.aligner.settings.visualize, tsys.aligner.settings.viz_tag) == (True, "image_alignment")
    assert (tsys.pose_settings.visualize, tsys.pose_settings.viz_tag) == (True, "pose_refine")
    off = System(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM), device="cpu")
    assert not off.aligner.settings.visualize and off.pose_settings is None
    assert topt._DIAGNOSTICS_SINK is None


def test_system_defaults_to_the_card():
    """No device named: the card, and an error where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM))


# ----------------------------------------------------------- DeviceSystem
@pytest.fixture(scope="module")
def device_runs(frames):
    """Both ``DeviceSystem``s over: bootstrap + one superstep, a superstep of
    black frames (the blackout of ``test_device_system``), then the rest.
    ``mid`` holds what each looked like right after the failed chunk."""
    images, _ = frames
    black = np.zeros_like(images[0])
    seq = images[:5] + [black] * 3 + images[5:]
    jds = JDeviceSystem(j_load_config(overrides=OVERRIDES),
                        camera=JCamera.create(**CAM, dtype=jnp.float64), **KW)
    jds.add_image(seq[0], 0.0)
    tds = DeviceSystem(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM),
                       ransac_uniforms=_uniforms(jds.host), device="cpu", **KW)
    tds.add_image(seq[0], 0.0)
    mid = {}
    for i, im in enumerate(seq[1:], start=1):
        jds.add_image(im, float(i))
        tds.add_image(im, float(i))
        if i == 7:
            mid = {"j": (jds.n_relocalizations, jds.state is None, jds.host.status.name),
                   "t": (tds.n_relocalizations, tds.state is None, tds.host.status.name),
                   "t_results": _results(tds)}
    jds.finish()
    tds.finish()
    return jds, tds, mid


def test_blackout_falls_back_to_the_host(device_runs):
    """A superstep of black frames: FAILED frames with no pose, one
    relocalization, the state unpacked to the host — in both packages."""
    _, _, mid = device_runs
    assert mid["t"] == mid["j"] == (1, True, "RELOCALIZATION")
    assert mid["t_results"][5:8] == ["FAILED"] * 3 and "FAILED" not in mid["t_results"][:5]


def test_recovery_resumes_on_the_device(device_runs):
    """After the blackout the host relocalizes, runs until its reference is a
    keyframe again, and ``_pack`` puts the state back: the same result per
    frame as the JAX package, and the last frames come from the device path
    (their metrics carry ``align_rmse``, the host's ``wall_ms``)."""
    jds, tds, _ = device_runs
    assert _results(tds) == _results(jds)
    assert len(tds.trajectory) == len(jds.trajectory) == N_FRAMES + 3
    res = _results(tds)
    assert "FAILED" not in res[8:]
    assert tds.n_relocalizations == jds.n_relocalizations == 1
    assert tds.state is not None and jds.state is not None
    via = ["device" if "align_rmse" in m else "host" for m in tds.metrics]
    assert via == ["device" if "align_rmse" in m else "host" for m in jds.metrics]
    assert via[:2] == ["host"] * 2 and via[2:8] == ["device"] * 6
    first_back = via.index("device", 8)
    assert via[8:first_back] == ["host"] * (first_back - 8) and first_back > 8
    assert res[first_back - 1] == "KEYFRAME"  # re-packed on a keyframe, not before
    assert via[first_back:] == ["device"] * (len(via) - first_back) and len(via) - first_back >= 3
    ok = [i for i, T in enumerate(jds.trajectory) if T is not None]
    cj = _centers([jds.trajectory[i] for i in ok])
    ct = _centers([tds.trajectory[i] for i in ok])
    path = float(np.sum(np.linalg.norm(np.diff(cj, axis=0), axis=-1)))
    assert np.linalg.norm(ct - cj, axis=-1).max() < 0.02 * path


def test_to_host_then_pack_is_the_identity(device_runs, tmp_path):
    """``_pack`` ∘ ``to_host`` gives back the map, the filter bank, the
    reference pose and slot, the velocity seed and the frame counter, bit for
    bit (float32 → float64 → float32); the feature-alignment tables of the
    seeds are re-sampled from the same images; the tracking reference's
    feature set is re-derived from the keyframe's rows. ``save_checkpoint`` goes the
    same way and a fresh ``System`` loads it."""
    _, tds, _ = device_runs
    before = to_numpy(tds.state)
    host = tds.to_host()
    assert host.status == SystemStatus.PROCESS_NEW_FRAME
    assert host.arena.num_keyframes() == int(before.map.kf_valid.sum())
    assert host.ref_frame.kf_slot == int(before.ref.ref_slot)
    tds._pack()
    after = to_numpy(tds.state)
    for f in before.map._fields:
        np.testing.assert_array_equal(getattr(after.map, f), getattr(before.map, f), err_msg=f)
    for f in before.filt.bank._fields:
        np.testing.assert_array_equal(getattr(after.filt.bank, f), getattr(before.filt.bank, f), err_msg=f)
    live = before.filt.bank.valid
    np.testing.assert_array_equal(after.filt.fa_ok[live], before.filt.fa_ok[live])
    np.testing.assert_allclose(after.filt.fa_patch[live], before.filt.fa_patch[live], atol=1e-3)
    for a, b in ((after.ref.T_ref_w, before.ref.T_ref_w), (after.T_cur_ref, before.T_cur_ref)):
        np.testing.assert_array_equal(a.rotation, b.rotation)
        np.testing.assert_array_equal(a.translation, b.translation)
    assert int(after.ref.ref_slot) == int(before.ref.ref_slot)
    assert int(after.frame_id) == int(before.frame_id) and not bool(after.failed)
    # the reference frame is re-seeded from its keyframe's rows that name a
    # point: few on a keyframe the device made (ROADMAP.md queue 3, the
    # negated rows), as in the JAX package
    rows = before.map.feat_valid[int(before.ref.ref_slot)] & (before.map.feat_point[int(before.ref.ref_slot)] >= 0)
    assert 1 <= after.ref.feats.valid.sum() <= rows.sum()
    path = str(tmp_path / "device.npz")
    tds.save_checkpoint(path)
    fresh = System(tds.config, camera=tds.camera, device="cpu")
    fresh.load_checkpoint(path)
    assert fresh.arena.num_keyframes() == host.arena.num_keyframes()
    assert fresh.status == SystemStatus.PROCESS_NEW_FRAME
    assert len(fresh.trajectory) == len(tds.trajectory)


# ------------------------------------------------------------- the modules
def _two_host_problem(n_side=(4, 4)):
    """A plane at z = 10 seen from the reference frame (the world), the last
    keyframe and the current frame; 16 features hosted by each of the first
    two, every point expressed in the reference frame."""
    taus = [np.zeros(6), [-0.15, 0.02, 0.0, 0.0, 0.004, 0.0], [0.06, -0.03, 0.04, 0.002, -0.003, 0.004]]
    (ref, kf, cur), Ts = _plane_images(21, taus)
    fx, fy, cx, cy = (CAM[k] for k in ("fx", "fy", "cx", "cy"))
    uu, vv = np.meshgrid(np.linspace(50, 270, n_side[0]), np.linspace(50, 190, n_side[1]))
    uv = np.stack([uu.ravel(), vv.ravel()], -1)
    n = len(uv)
    uv_host = np.concatenate([uv, uv + 0.3]).astype(np.float32)  # the second host's off the pixel grid
    b = np.stack([(uv_host[:, 0] - cx) / fx, (uv_host[:, 1] - cy) / fy, np.ones(2 * n)], -1)
    R, t = Ts[1][:3, :3], Ts[1][:3, 3]
    ray = b[n:] @ R  # Rᵀ b, a row at a time: the keyframe's rays in the world
    origin = -R.T @ t
    pts = np.concatenate([b[:n] * 10.0, origin + ((10.0 - origin[2]) / ray[:, 2])[:, None] * ray])
    host = np.concatenate([np.zeros(n, np.int32), np.ones(n, np.int32)])
    valid = np.ones(2 * n, bool)
    valid[-1] = False
    return ref, kf, cur, uv_host, host, pts.astype(np.float32), valid, Ts[2]


@pytest.mark.parametrize("use_esm", [True, False], ids=["esm", "inverse-compositional"])
def test_align_two_hosts_matches_pallas_backend(use_esm):
    """``SparseImageAlign.align`` at the class defaults (12 iterations a
    level, no taper) over two levels and two host images, against the JAX
    aligner with ``backend="pallas"`` (K1 in interpret mode, run level by
    level outside ``jit`` so that one interpreted kernel serves both
    levels). The two poses put every feature within 0.01 px of each other
    (measured: at most 0.005 px over four scenes; float32 on both sides, the
    same accept/reject path but for a stall test at its edge, which costs one
    late iteration); rmse 1 %. With ESM off the Jacobian is
    the reference image's alone, and the two settings must differ."""
    ref, kf, cur, uv_host, host, pts, valid, T_true = _two_host_problem()
    fx, fy, cx, cy = (CAM[k] for k in ("fx", "fy", "cx", "cy"))
    levels = 2
    pr, pk, pc = (build_pyramid(_t(x), levels) for x in (ref, kf, cur))
    ja = JSparseImageAlign(patch_size=5, min_level=0, max_level=levels - 1, backend="pallas",
                           use_esm=use_esm)
    ta = SparseImageAlign(patch_size=5, min_level=0, max_level=levels - 1, use_esm=use_esm)
    assert ta.settings == SparseImageAlign.DEFAULT_SETTINGS and ta.level_taper == 0
    assert (ta.settings.max_iterations, ta.settings.min_rel_decrease) == (12, 1e-3)
    assert [ta.level_iterations(lv) for lv in range(levels)] == [12, 12]
    jfeats = JAlignFeatures(jnp.asarray(uv_host), jnp.asarray(host), jnp.asarray(pts), jnp.asarray(valid))
    jhost = tuple(jnp.stack([jnp.asarray(_np(a.images[lv])), jnp.asarray(_np(b.images[lv]))])
                  for lv, (a, b) in enumerate(zip([pr] * levels, [pk] * levels)))
    jcur = tuple(jnp.asarray(_np(im)) for im in pc.images)
    f32 = jnp.float32
    jT, jrmse, _ = ja._align_impl(JSE3(jnp.eye(3, dtype=f32), jnp.zeros(3, f32)), jhost, jcur, jfeats,
                                  f32(fx), f32(fy), f32(cx), f32(cy))
    tfeats = AlignFeatures(_t(uv_host), _t(host), _t(pts), _t(valid))
    thost = [(pr.images[lv], pk.images[lv]) for lv in range(levels)]
    tT, trmse, tstatus = ta.align(SE3.identity(), thost, pc.images, tfeats, fx, fy, cx, cy)
    # translation along x and rotation about y are nearly one direction of this
    # scene (a plane 10 away), so the poses are compared where the alignment
    # measures them: by where they put the features
    def project(R, t):
        p = pts.astype(np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
        return np.stack([fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy], -1)

    apart = np.abs(project(_np(tT.rotation), _np(tT.translation))
                   - project(jT.rotation, jT.translation)).max()
    assert apart < 0.01, apart
    np.testing.assert_allclose(float(trmse), float(jrmse), rtol=1e-2)
    assert int(tstatus) == 0
    # and it finds the motion: the plane is 10 away, the step 0.08
    assert np.linalg.norm(_np(tT.translation) - T_true[:3, 3]) < 0.02
    if not use_esm:
        eT, _, _ = SparseImageAlign(patch_size=5, min_level=0, max_level=levels - 1).align(
            SE3.identity(), thost, pc.images, tfeats, fx, fy, cx, cy)
        assert np.abs(_np(eT.translation) - _np(tT.translation)).max() > 1e-5


def _script(arena, point_type):
    """One scripted life of an arena: keyframes, points, features with and
    without patch tables, a point removed, an overflowing feature table, a
    keyframe evicted (orphans deleted), a similarity transform."""
    g = np.random.default_rng(5)
    out = []
    s0 = arena.add_keyframe(10, np.eye(4), "pyr0")
    T1 = np.eye(4)
    T1[:3, 3] = [-0.5, 0.0, 0.1]
    s1 = arena.add_keyframe(13, T1, "pyr1")
    pts = [arena.add_point(g.uniform([-2, -1, 5], [2, 1, 9]), point_type.GOOD if i % 2 else point_type.CANDIDATE)
           for i in range(12)]
    out.append(pts)
    P2 = arena.align_patch_size ** 2
    tabs = [g.normal(size=(8, P2)).astype(np.float32) for _ in range(3)]
    out.append(arena.add_features(s0, g.uniform(0, 300, (8, 2)), np.asarray(pts[:8]), *tabs,
                                  g.random(8) > 0.2))
    out.append(arena.add_features(s1, g.uniform(0, 300, (9, 2)), np.asarray(pts[3:12])))
    arena.remove_point(pts[4])
    out.append(arena.point_observations(pts[5]))
    T2 = np.eye(4)
    T2[:3, 3] = [-1.0, 0.1, 0.2]
    s2 = arena.add_keyframe(16, T2, "pyr2")
    out.append(arena.add_features(s2, g.uniform(0, 300, (20, 2)), np.asarray((pts[8:] * 5)[:20])))  # overflow
    out.append((arena.closest_keyframe(np.array([0.4, 0.0, 0.0])), arena.furthest_keyframe(np.array([0.4, 0.0, 0.0])),
                arena.keyframe_by_id(13), arena.keyframe_by_id(99)))
    arena.remove_keyframe(s0)  # points 0..2 lose their only observation
    out.append((arena.num_keyframes(), arena.keyframe_slots().tolist(), int(arena.pt_valid.sum())))
    ang = 0.3
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    arena.transform(Rz, np.array([0.5, -0.2, 0.1]), 1.7)
    out.append(arena.add_keyframe(19, np.eye(4), "pyr3"))  # the freed slot is taken again
    return out


def test_map_arena_matches_jax_exactly():
    """The same scripted sequence of operations on both arenas: every return
    value and every array equal, and the BA window packs alike."""
    kw = dict(max_keyframes=4, max_points=16, max_features_per_kf=12)
    ja, ta = JMapArena(**kw), MapArena(**kw)
    jout, tout = _script(ja, JPointType), _script(ta, PointType)
    assert tout == jout
    jd, td = arena_to_numpy(ja), arena_to_numpy(ta)
    for k in ARENA_KEYS:
        assert td[k].dtype == jd[k].dtype, k
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    assert ta.kf_pyramids == ja.kf_pyramids
    jw, tw = ja.ba_window(dtype=jnp.float64), ta.ba_window(dtype=np.float64)
    for k in ("slots", "live_pts", "cam_idx", "pt_idx", "uv"):
        assert tw[k].dtype == jw[k].dtype, k
        np.testing.assert_array_equal(tw[k], jw[k], err_msg=k)
    assert tw["points"].dtype == np.float64 and len(tw["cam_idx"]) >= 10
    np.testing.assert_array_equal(tw["poses_R"], np.asarray(jw["poses"].rotation))
    np.testing.assert_array_equal(tw["poses_t"], np.asarray(jw["poses"].translation))
    np.testing.assert_array_equal(tw["points"], np.asarray(jw["points"]))
    back = arena_from_numpy(td)
    for k in ARENA_KEYS:
        np.testing.assert_array_equal(getattr(back, k), td[k], err_msg=k)
    assert (back.max_keyframes, back.max_points, back.max_features_per_kf, back.align_patch_size) == (4, 16, 12, 5)


def test_reproject_map_matches_pallas_backend(host_runs, monkeypatch):
    """``reproject_map`` on the JAX System's arena before frame 6, at that
    frame's pose, with equal generators: the same match set (point slots, in
    order), the same trial and candidate counts and the same counters,
    promotions and kills in the arena; refined positions within 2e-3 px and
    errors within 1e-3 relative — K2's parity tolerance, float32 on both
    sides. The JAX side runs K2 in interpret mode (patched in here: on the
    CPU it would take its XLA branch)."""
    jsys, _, seq, extra = host_runs
    monkeypatch.setattr(j_reproject_mod, "align_features_2d_cached",
                        functools.partial(j_reproject_mod.align_features_2d_cached, backend="pallas"))
    T = jsys.trajectory[SNAPSHOT_AT]
    grad = build_pyramid(_t(seq[SNAPSHOT_AT].astype(np.float32)), 1).base_gradient
    intr = tuple(float(np.float32(CAM[k])) for k in ("fx", "fy", "cx", "cy"))
    ja = JMapArena(max_keyframes=10, max_points=1024, max_features_per_kf=160)
    for k, v in extra["arena"].items():
        setattr(ja, k, int(v) if k == "kf_counter" else v.copy())
    ja.intrinsics = tuple(jnp.float32(v) for v in intr)
    ta = arena_from_numpy(extra["arena"])
    ta.intrinsics = intr
    kw = dict(cell_size=24, max_matches=96, max_error=50.0, patch_size=5)
    jrep = j_reproject_mod.reproject_map(
        JSE3(jnp.asarray(T[:3, :3], jnp.float32), jnp.asarray(T[:3, 3], jnp.float32)),
        jnp.asarray(_np(grad)), ja, rng=np.random.default_rng(3), **kw)
    trep = reproject_map(SE3(_t(T[:3, :3].astype(np.float32)), _t(T[:3, 3].astype(np.float32))),
                         grad, ta, rng=np.random.default_rng(3), **kw)
    assert (trep.n_candidates, trep.n_trials) == (jrep.n_candidates, jrep.n_trials)
    np.testing.assert_array_equal(trep.pt_slot, jrep.pt_slot)
    assert len(trep.pt_slot) >= 40
    np.testing.assert_allclose(trep.uv, jrep.uv, atol=2e-3)
    np.testing.assert_allclose(trep.error, jrep.error, rtol=1e-3, atol=1e-4)
    for k in ("pt_succeeded", "pt_failed", "pt_type", "pt_valid", "feat_valid", "feat_point"):
        np.testing.assert_array_equal(getattr(ta, k), getattr(ja, k), err_msg=k)
    assert ta.pt_succeeded.sum() > extra["arena"]["pt_succeeded"].sum()


def test_undistort_maps_match_jax():
    """The remap grids of a camera with distortion (float64): 1e-9 px; and
    ``preprocess_image`` leaves an undistorted camera's image alone."""
    dist = [-0.28, 0.07, 2e-4, 1e-5, 0.0]
    jc = JCamera.create(**CAM, dist=dist, dtype=jnp.float64)
    tc = PinholeCamera.create(**CAM, dist=dist, dtype=torch.float64)
    assert tc.has_distortion and not PinholeCamera.create(**CAM).has_distortion
    from sdvo_tpu.geometry.camera import build_undistort_maps as j_maps

    for a, b in zip(build_undistort_maps(tc), j_maps(jc)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-9)
    cfg = load_config(overrides=OVERRIDES)
    img = np.random.default_rng(0).uniform(0, 255, (CAM["height"], CAM["width"]))
    plain = System(cfg, camera=PinholeCamera.create(**CAM), device="cpu")
    assert plain.preprocess_image(img) is img
    warped = System(cfg, camera=PinholeCamera.create(**CAM, dist=dist), device="cpu").preprocess_image(img)
    jwarped = JSystem(j_load_config(overrides=OVERRIDES),
                      camera=JCamera.create(**CAM, dist=dist)).preprocess_image(img)
    np.testing.assert_allclose(warped, jwarped, atol=2e-2)  # float32 maps there, float64 here
    assert np.abs(warped - img).max() > 1.0


# -------------------------------------------------------------------- CLI
def _dataset(tmp_path, images):
    """The frames as PNG files, the scene's camera as an OpenCV-YAML
    calibration file and a config that names both; returns (config path,
    output dir)."""
    img_dir, out_dir = tmp_path / "images", tmp_path / "out"
    img_dir.mkdir()
    for i, im in enumerate(images):
        Image.fromarray(im.astype(np.uint8)).save(img_dir / f"{i:06d}.png")
    calib = tmp_path / "cam.yaml"
    calib.write_text("%YAML:1.0\nK: !!opencv-matrix\n   rows: 3\n   cols: 3\n   dt: d\n"
                     f"   data: [ {CAM['fx']}, 0., {CAM['cx']}, 0., {CAM['fy']}, {CAM['cy']}, 0., 0., 1. ]\n"
                     "d: !!opencv-matrix\n   rows: 5\n   cols: 1\n   dt: d\n   data: [ 0., 0., 0., 0., 0. ]\n")
    cfg = {**OVERRIDES, "file_paths": {"camera_calibration_file": str(calib),
                                       "image_data_path": str(img_dir), "output_dir": str(out_dir)}}
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    return str(cfg_path), out_dir


@pytest.mark.parametrize("path_flags", [["--host-system"], ["--chunk", "1"]], ids=["host-system", "device"])
def test_cli_writes_poses_and_metrics_on_cpu(frames, tmp_path, path_flags, capsys):
    """``python -m sdvo_tpu_torch.main --cpu`` on eight frames from disk, on
    both paths: ``out.txt`` holds a pose for every frame, ``metrics.jsonl``
    a record."""
    cfg_path, out_dir = _dataset(tmp_path, frames[0][:8])
    assert cli.main([cfg_path, "--cpu", *path_flags]) == 0
    lines = (out_dir / "out.txt").read_text().strip().splitlines()
    assert len(lines) == 8 and all(len(ln.split()) == 12 for ln in lines)
    records = [json.loads(ln) for ln in (out_dir / "metrics.jsonl").read_text().strip().splitlines()]
    assert [r["frame"] for r in records] == list(range(8))
    assert [r["result"] for r in records].count("KEYFRAME") >= 3 and "FAILED" not in [r["result"] for r in records]
    said = capsys.readouterr().out
    assert ("system summary" in said) if path_flags == ["--host-system"] else ("8/8 frames tracked" in said)


def test_cli_host_system_in_float64(frames, tmp_path):
    """``--f64 --host-system``: the kernels' functions stay float32, the
    rest computes in float64; ``--max-frames`` cuts the run to five frames,
    which all track."""
    cfg_path, out_dir = _dataset(tmp_path, frames[0][:8])
    assert cli.main([cfg_path, "--cpu", "--f64", "--host-system", "--max-frames", "5"]) == 0
    lines = (out_dir / "out.txt").read_text().strip().splitlines()
    assert len(lines) == 5 and "Failed" not in lines
    assert os.path.exists(out_dir / "metrics.jsonl")
