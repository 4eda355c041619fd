"""The port's main path as a whole against the JAX ``DeviceSystem``.

Scene: the 320×240 ridge sequence of ``test_pipeline_e2e.make_sequence``
with the configuration of ``test_device_system._make``. Both systems
bootstrap on frames 0–1 with the same RANSAC uniforms (drawn with
``jax.random`` from the key the JAX ``System`` splits), so their initial
states are held field by field. Two supersteps (six frames) follow; the JAX
side runs its CPU default path (XLA), the port its kernels' plain versions,
whose semantics differ (binned vs histogram MAD, per-feature freeze in
feature alignment, iteration taper), so the trajectories are held within a
tolerance that covers that, stated below.
"""

import sys
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.config import load_config as j_load_config
from sdvo_tpu.geometry.camera import PinholeCamera as JCamera
from sdvo_tpu.pipeline.device_system import DeviceSystem as JDeviceSystem

from sdvo_tpu_torch.config import load_config
from sdvo_tpu_torch.convert import to_numpy, vo_state_from_numpy
from sdvo_tpu_torch.dataio.evaluate import ate_rmse
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

from test_pipeline_e2e import CAM, make_sequence

torch.set_num_threads(2)

OVERRIDES = {
    "camera": {"img_width": CAM["width"], "img_height": CAM["height"]},
    "initialization": {"min_detected_points": 60, "desired_detected_points": 150,
                       "threshold_gradient_magnitude": 20, "disparity_threshold": 2},
    "algorithm": {"cell_pixel_size": 24, "min_tracked_features": 20, "max_dropped_features": 150,
                  "max_reprojection_matches": 96, "max_features_per_frame": 160,
                  "max_points": 1024, "max_filters": 256, "keyframe_every_n": 3},
}
KW = dict(supersteps_per_chunk=2, max_promote=32, ba_points=256, ba_iterations=4)


def _centers(traj):
    return np.asarray([-T[:3, :3].T @ T[:3, 3] for T in traj])


@pytest.fixture(scope="module")
def runs():
    _, images, poses = make_sequence(np.random.default_rng(7), n_frames=8)
    frames = [np.asarray(im, np.float64) for im in images]
    jds = JDeviceSystem(j_load_config(overrides=OVERRIDES),
                        camera=JCamera.create(**CAM, dtype=jnp.float64), **KW)
    jds.add_image(frames[0], 0.0)
    # the RANSAC draws of the JAX System's first bootstrap attempt
    n_feat = len(jds.host.ref_frame.feat_uv)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    uniforms = np.asarray(jax.random.uniform(sub, (256, n_feat), dtype=jnp.float64))
    jds.add_image(frames[1], 1.0)
    j_boot = jax.device_get(jds.state)

    tds = DeviceSystem(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM),
                       ransac_uniforms=uniforms, device="cpu", **KW)
    tds.add_image(frames[0], 0.0)
    tds.add_image(frames[1], 1.0)
    t_boot = to_numpy(tds.state)
    for i, f in enumerate(frames[2:], start=2):
        jds.add_image(f, float(i))
        tds.add_image(f, float(i))
    jds.finish()
    tds.finish()
    return jds, tds, j_boot, t_boot, poses


def test_bootstrap_state_matches(runs):
    """Held field by field: exact for masks, slots, counters and the detected
    features; sampled tables to float32 rounding. The map scale is a gauge
    freedom of the two-view BA (only the first camera is fixed), so ulp-level
    differences in KLT move it by ~5e-4 relative (measured 3.4e-4): point
    positions, depths and Jacobians are held to 2e-3 relative."""
    _, _, j, t, _ = runs
    jm, tm = j.map, t.map
    for f in ("kf_valid", "kf_frame_id", "kf_counter", "feat_point", "feat_valid", "feat_ok",
              "pt_valid", "pt_type"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    assert int(tm.pt_valid.sum()) >= 30
    np.testing.assert_allclose(tm.kf_R, jm.kf_R, atol=1e-5)
    np.testing.assert_allclose(tm.kf_t, jm.kf_t, atol=1e-5)
    np.testing.assert_allclose(tm.pt_pos, jm.pt_pos, rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(tm.feat_uv, jm.feat_uv, atol=1e-3)
    for f in ("feat_patch", "feat_gx", "feat_gy"):
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f), atol=0.05, err_msg=f)
    np.testing.assert_array_equal(tm.kf_img0, jm.kf_img0)
    jb, tb = j.filt.bank, t.filt.bank
    for f in ("valid", "kf_slot", "born_kf", "uv_ref"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
    for f in ("mu", "var", "max_inv_depth", "ref_patch", "bearing_ref"):
        np.testing.assert_allclose(getattr(tb, f), getattr(jb, f), rtol=2e-3, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(t.filt.fa_ok, j.filt.fa_ok)
    np.testing.assert_allclose(t.filt.fa_patch, j.filt.fa_patch, atol=1e-3)
    np.testing.assert_array_equal(t.ref.feats.valid, j.ref.feats.valid)
    np.testing.assert_allclose(t.ref.feats.points_ref, j.ref.feats.points_ref, rtol=2e-3, atol=1e-6)
    for tv, jv in zip(t.ref.align_vis, j.ref.align_vis):
        np.testing.assert_array_equal(tv, jv)
    for tp, jp in zip(t.ref.align_patches, j.ref.align_patches):
        np.testing.assert_allclose(tp, jp, atol=1e-3)
    for tJ, jJ in zip(t.ref.align_J, j.ref.align_J):
        np.testing.assert_allclose(tJ, jJ, rtol=2e-3, atol=2e-3 * np.abs(jJ).max())
    np.testing.assert_allclose(t.T_cur_ref.rotation, j.T_cur_ref.rotation, atol=1e-5)
    np.testing.assert_allclose(t.T_cur_ref.translation, j.T_cur_ref.translation, atol=1e-5)
    assert int(t.frame_id) == int(j.frame_id) == 2


def test_two_supersteps_track_like_reference(runs):
    """Every frame tracked, the same keyframe cadence, and camera centres
    within 2 % of the path length of the JAX run. The bound covers the
    XLA-vs-kernel semantics: at this scale (median depth 1, ~0.012 per
    frame) the two alignments differ by ~1e-4 per frame."""
    jds, tds, _, _, poses = runs
    assert len(tds.trajectory) == len(jds.trajectory) == 8
    assert all(T is not None for T in tds.trajectory)
    assert [m["result"] for m in tds.metrics] == [m["result"] for m in jds.metrics]
    cj, ct = _centers(jds.trajectory), _centers(tds.trajectory)
    path = float(np.sum(np.linalg.norm(np.diff(cj, axis=0), axis=-1)))
    err = np.linalg.norm(ct - cj, axis=-1).max()
    assert err < 0.02 * path, (err, path)
    gt = _centers(poses)
    assert ate_rmse(ct, gt) < 0.05


def test_state_round_trip(runs):
    """``vo_state_from_numpy`` ∘ ``to_numpy`` keeps every field and dtype."""
    _, tds, _, _, _ = runs
    back = vo_state_from_numpy(to_numpy(tds.state), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(back)), jax.tree_util.tree_leaves(to_numpy(tds.state))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_imports_without_jax():
    """Every module of the port (the CLI and the multi-sequence package
    ``parallel`` included) imports where neither JAX nor the JAX package can
    be imported."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['sdvo_tpu'] = None; "
            "import importlib, pkgutil, sdvo_tpu_torch; "
            "names = [m.name for m in pkgutil.walk_packages(sdvo_tpu_torch.__path__, 'sdvo_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert 'sdvo_tpu_torch.main' in names and 'sdvo_tpu_torch.pipeline.system' in names "
            "and 'sdvo_tpu_torch.parallel.multi_seq' in names and len(names) >= 40, names; "
            "import sdvo_tpu_torch.parallel; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=__import__("os").path.dirname(__import__("os").path.dirname(__file__)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# one frame of the JAX DeviceVO with backend="pallas", in a process of its
# own: each interpreted kernel takes 1–2 GB to compile on the CPU, and a
# process frees that only when it exits
_PALLAS_FRAME = r"""
import pickle, sys
sys.path[:0] = sys.argv[3:5]
import conftest  # CPU platform, float64 enabled
import jax, jax.numpy as jnp
from test_torch_device_system import CAM, KW, OVERRIDES, JCamera, JDeviceSystem, j_load_config
state, image, is_kf = pickle.load(open(sys.argv[1], "rb"))
jp = JDeviceSystem(j_load_config(overrides=OVERRIDES), camera=JCamera.create(**CAM, dtype=jnp.float64),
                   backend="pallas", **KW)
state, out = jp.vo._frame_step(jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(image), is_kf)
pickle.dump(jax.device_get((state, out)), open(sys.argv[2], "wb"))
"""


@pytest.mark.slow
def test_superstep_matches_pallas_path(runs, tmp_path):
    """One superstep (frames 2–4, the last a keyframe) from the same
    converted bootstrap state: the port against the JAX ``DeviceVO`` with
    ``backend="pallas"`` (its kernels in interpret mode), state to state.
    Both follow the kernels' semantics, so masks, slots and counters are
    equal and poses agree to float32 rounding (1e-4); point positions and
    filter moments to 1e-3 relative (the triangulation and BA normal
    equations lose digits)."""
    import os
    import pickle

    from sdvo_tpu_torch.pipeline.device_system import DeviceVO

    _, tds, j_boot, _, _ = runs
    _, images, _ = make_sequence(np.random.default_rng(7), n_frames=5)
    imgs = np.stack([np.asarray(im, np.float32) for im in images[2:5]])
    tests = os.path.dirname(os.path.abspath(__file__))
    j, j_outs = j_boot, []
    for i in range(3):
        src, dst = tmp_path / f"in{i}.pkl", tmp_path / f"out{i}.pkl"
        with open(src, "wb") as f:
            pickle.dump((j, imgs[i], i == 2), f)
        proc = subprocess.run([sys.executable, "-c", _PALLAS_FRAME, str(src), str(dst), tests,
                               os.path.dirname(tests)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(dst, "rb") as f:
            j, out = pickle.load(f)
        j_outs.append(out)
    j_out = type(j_outs[0])(*[np.stack(x) for x in zip(*j_outs)])
    vo = DeviceVO(tds.camera, tds.scfg)
    t_state, t_out = vo.superstep(vo_state_from_numpy(j_boot, device="cpu"), torch.from_numpy(imgs))
    t = to_numpy(t_state)
    np.testing.assert_array_equal(t_out.ok.numpy(), j_out.ok)
    np.testing.assert_array_equal(t_out.n_matches.numpy(), j_out.n_matches)
    np.testing.assert_allclose(t_out.R.numpy(), j_out.R, atol=1e-4)
    np.testing.assert_allclose(t_out.t.numpy(), j_out.t, atol=1e-4)
    for f in ("kf_valid", "kf_frame_id", "kf_counter", "feat_point", "feat_valid", "pt_valid",
              "pt_type", "pt_succ", "pt_fail"):
        np.testing.assert_array_equal(getattr(t.map, f), getattr(j.map, f), err_msg=f)
    np.testing.assert_allclose(t.map.pt_pos, j.map.pt_pos, rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(t.filt.bank.valid, j.filt.bank.valid)
    np.testing.assert_array_equal(t.filt.pending, j.filt.pending)
    np.testing.assert_allclose(t.filt.bank.mu, j.filt.bank.mu, rtol=1e-3)
    np.testing.assert_array_equal(t.ref.feats.valid, j.ref.feats.valid)
