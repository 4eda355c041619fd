"""BASELINE config 2 (EuRoC MH_01 mono, 5-level pyramid) through the port
against the JAX package on the CPU, at ``tests/test_euroc.py``'s camera
(fx 458, fy 457, cx 376, cy 240, 752×480) and overrides
(``max_level_image_pyramid`` 4), on the dolly of
``tests/test_pipeline_e2e.py::make_sequence`` (texture seed 11), rendered
by ``dataio.synthetic.render_dolly_sequence`` bit for bit as that function
renders it. ``chip_smoke.run_euroc`` runs the JAX test's ``System`` and a
``DeviceSystem`` over 2 + 24 frames of it on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.align.image_alignment import AlignFeatures as JAlignFeatures
from sdvo_tpu.config import load_config as j_load_config
from sdvo_tpu.geometry.camera import PinholeCamera as JCamera
from sdvo_tpu.geometry.se3 import SE3 as JSE3
from sdvo_tpu.pipeline.device_system import DeviceSystem as JDeviceSystem
from sdvo_tpu.pipeline.device_system import DeviceVO as JDeviceVO

from sdvo_tpu_torch.align.image_alignment import AlignFeatures
from sdvo_tpu_torch.convert import to_numpy, vo_state_from_numpy
from sdvo_tpu_torch.dataio.synthetic import EUROC_CAMERA, render_dolly_sequence
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.pyramid import build_pyramid
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem, DeviceVO

import chip_smoke

torch.set_num_threads(2)

LEVELS = chip_smoke.EUROC_LEVELS


@pytest.fixture(scope="module")
def frames():
    return render_dolly_sequence(EUROC_CAMERA, 5, chip_smoke.EUROC_SEED)


def _ridge_points(uv, cam):
    """The world points (= the reference camera's, at the identity) that the
    pixels ``uv`` of frame 0 see on the ridge: z = 8 where x < 1, else 14."""
    fx, fy, cx, cy = (cam[k] for k in ("fx", "fy", "cx", "cy"))
    ray = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, np.ones(len(uv))], -1)
    near = ray * 8.0
    return np.where((near[:, 0] < 1.0)[:, None], near, ray * 14.0).astype(np.float32)


def test_five_level_alignment_matches_jax(frames):
    """The device path's coarse-to-fine alignment at 5 levels
    (``DeviceVO``'s aligner: 4/4/6/8/10 iterations at levels 0-4, exit at
    2e-3) of frame 1 against frame 0, 150 grid features with their ridge
    points, from the identity: the port's ``align_precomputed`` against the
    JAX one on the kernels (``backend="pallas"``, K1 in interpret mode).
    Compared where the alignment measures the pose, by where it puts the
    features: within 0.01 px (``test_align_two_hosts_matches_pallas_backend``'s
    tolerance); and it finds the 0.12 m step within 0.02 m."""
    images, poses = frames
    cam = EUROC_CAMERA
    fx, fy, cx, cy = (cam[k] for k in ("fx", "fy", "cx", "cy"))
    cfg = chip_smoke.euroc_config()
    tds = DeviceSystem(cfg, camera=PinholeCamera.create(**cam), device="cpu")
    tvo = tds.vo
    jvo = JDeviceVO(JCamera.create(**cam, dtype=jnp.float64), tds.scfg, backend="pallas")
    assert tds.scfg.levels == LEVELS
    assert [tvo.aligner.level_iterations(lv) for lv in range(LEVELS)] == chip_smoke.EUROC_SCHEDULE
    uu, vv = np.meshgrid(np.linspace(40, 712, 15), np.linspace(40, 440, 10))
    uv = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)
    pts = _ridge_points(uv, cam)
    valid = np.ones(len(uv), bool)
    pr, pc = (build_pyramid(torch.from_numpy(im.astype(np.float32)), LEVELS) for im in images[:2])
    assert pr.images[-1].shape == (30, 47)

    f32 = jnp.float32
    jfeats = JAlignFeatures(jnp.asarray(uv), jnp.zeros(len(uv), jnp.int32), jnp.asarray(pts), jnp.asarray(valid))
    jtabs = jvo.aligner.precompute_ref_windows(tuple(jnp.asarray(x.numpy()) for x in pr.images), jfeats,
                                               f32(fx), f32(fy))
    jT, _, _ = jvo.aligner.align_precomputed(JSE3(jnp.eye(3, dtype=f32), jnp.zeros(3, f32)), jtabs,
                                             tuple(jnp.asarray(x.numpy()) for x in pc.images), jfeats,
                                             f32(fx), f32(fy), f32(cx), f32(cy))
    tfeats = AlignFeatures(torch.from_numpy(uv), torch.zeros(len(uv), dtype=torch.int32), torch.from_numpy(pts),
                           torch.from_numpy(valid))
    ttabs = tvo.aligner.precompute_ref_windows(pr.images, tfeats, fx, fy)
    tT, _, _ = tvo.aligner.align_precomputed(SE3.identity(), ttabs, pc.images, tfeats, fx, fy, cx, cy)

    def project(R, t):
        p = pts.astype(np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
        return np.stack([fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy], -1)

    apart = np.abs(project(tT.rotation.numpy(), tT.translation.numpy()) - project(jT.rotation, jT.translation)).max()
    assert apart < 0.01, apart
    assert np.linalg.norm(tT.translation.numpy() - poses[1][:3, 3]) < 0.02


def test_superstep_at_euroc_preset_matches_jax(frames):
    """One ``DeviceVO.superstep`` (frames 2-4, the last a keyframe) at the
    EuRoC preset from the same state: the JAX ``DeviceSystem``'s after its
    bootstrap on frames 0-1, converted to the port (``vo_state_from_numpy``).
    The JAX side runs its CPU default path (XLA: histogram MAD, no K2
    freeze, no taper), the port its kernels' plain versions, so, as in
    ``test_two_supersteps_track_like_reference``, the frames are held to the
    same results and keyframe, and camera centres within 2 % of the path
    length from frame 1; the keyframe step's counters and masks to the
    same values."""
    images, _ = frames
    cam = EUROC_CAMERA
    jds = JDeviceSystem(j_load_config(overrides=chip_smoke.EUROC_OVERRIDES),
                        camera=JCamera.create(**cam, dtype=jnp.float64))
    for i in range(2):
        jds.add_image(np.asarray(images[i], np.float64), float(i))
    assert jds.bootstrapped
    j_boot = jax.device_get(jds.state)
    imgs = np.stack([np.asarray(im, np.float32) for im in images[2:5]])
    j_state, j_out = jds.vo.chunk_fn(1)(jds.state, jnp.asarray(imgs[None]))
    j_out = jax.device_get(j_out)
    tds = DeviceSystem(chip_smoke.euroc_config(), camera=PinholeCamera.create(**cam), device="cpu")
    t_state, t_out = tds.vo.superstep(vo_state_from_numpy(j_boot, device="cpu"), torch.from_numpy(imgs))
    assert t_out.ok.all() and np.asarray(j_out.ok).all()
    np.testing.assert_array_equal(t_out.is_kf.numpy(), np.asarray(j_out.is_kf)[0])
    centres = lambda R, t: -np.einsum("nji,nj->ni", R, t)  # noqa: E731
    cj = centres(np.asarray(j_out.R)[0], np.asarray(j_out.t)[0])
    ct = centres(t_out.R.numpy(), t_out.t.numpy())
    T1 = j_boot.ref.T_ref_w
    c1 = -np.asarray(T1.rotation).T @ np.asarray(T1.translation)
    path = float(np.sum(np.linalg.norm(np.diff(np.concatenate([c1[None], cj]), axis=0), axis=-1)))
    gap = np.linalg.norm(ct - cj, axis=-1).max()
    assert gap < 0.02 * path, (gap, path)
    t, j = to_numpy(t_state), jax.device_get(j_state)
    for f in ("kf_valid", "kf_counter", "kf_frame_id"):
        np.testing.assert_array_equal(getattr(t.map, f), getattr(j.map, f), err_msg=f)
    assert int(t.frame_id) == int(j.frame_id) == 5
