"""The public options of the JAX package that the port's entry points take
beside their defaults, each with its non-default value against the JAX
function on the same inputs (made with numpy from a seed):
``bilinear_sample(clamp=False)``, ``build_pyramid(quantize=True)``,
``bootstrap_two_view(run_ba=False)``, ``multi_chunk_fn(mesh, axis=...)`` and
``DeviceVO(align_settings=...)``. K1's ``freeze_sigma`` is held against the
Pallas kernel in ``test_torch_kernels.py`` and ``test_torch_vmap_kernels.py``.
Tolerances are stated per test.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.align.image_alignment import AlignFeatures as JAlignFeatures
from sdvo_tpu.geometry.camera import PinholeCamera as JCamera
from sdvo_tpu.geometry.se3 import SE3 as JSE3
from sdvo_tpu.image.interp import bilinear_sample as j_bilinear_sample
from sdvo_tpu.image.pyramid import build_pyramid as j_build_pyramid
from sdvo_tpu.optim.optimizer import LMSettings as JLMSettings
from sdvo_tpu.parallel.mesh import make_vo_mesh as j_make_vo_mesh
from sdvo_tpu.parallel.multi_seq import multi_chunk_fn as j_multi_chunk_fn
from sdvo_tpu.pipeline.bootstrap import bootstrap_two_view as j_bootstrap_two_view
from sdvo_tpu.pipeline.device_system import DeviceVO as JDeviceVO
from sdvo_tpu.pipeline.device_system import SuperstepConfig as JSuperstepConfig

from sdvo_tpu_torch.align.image_alignment import AlignFeatures
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.interp import bilinear_sample
from sdvo_tpu_torch.image.pyramid import build_pyramid
from sdvo_tpu_torch.optim.optimizer import LMSettings
from sdvo_tpu_torch.parallel import make_vo_mesh
from sdvo_tpu_torch.parallel.multi_seq import multi_chunk_fn
from sdvo_tpu_torch.pipeline.bootstrap import bootstrap_two_view
from sdvo_tpu_torch.pipeline.device_system import DeviceVO, SuperstepConfig

from test_pipeline_e2e import CAM, make_sequence
from test_torch_kernels import _pair

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def test_bilinear_sample_unclamped_matches_jax():
    """``clamp=False``: the corners are gathered where they fall in the
    flattened image, with ``jnp.take``'s rule for flat indices outside it
    (from the end down to −H·W, NaN beyond). Points inside, on every edge,
    one and two pixels out and far out: the same values bit for bit (one
    formula on float32 on both sides), NaN at the same places, the same
    ``valid``; the clamped default still matches the clamped JAX call."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (12, 17)).astype(np.float32)
    uv = np.concatenate([rng.uniform(-3.0, [20.0, 15.0], (200, 2)),
                         [[-0.5, -0.5], [16.5, 11.5], [16.2, 5.5], [-1.5, 2.0], [2.0, -3.0],
                          [-40.0, 0.0], [3.0, 40.0], [0.0, 11.0], [16.0, 0.0]]]).astype(np.float32)
    for clamp in (False, True):
        jv, jok = j_bilinear_sample(jnp.asarray(img), jnp.asarray(uv), clamp=clamp)
        tv, tok = bilinear_sample(torch.from_numpy(img), torch.from_numpy(uv), clamp=clamp)
        np.testing.assert_array_equal(_np(tok), np.asarray(jok))
        np.testing.assert_array_equal(np.isnan(_np(tv)), np.isnan(np.asarray(jv)))
        np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    assert np.isnan(_np(tv)).sum() == 0
    unclamped = _np(bilinear_sample(torch.from_numpy(img), torch.from_numpy(uv), clamp=False)[0])
    assert np.isnan(unclamped).sum() >= 3 and not np.array_equal(unclamped, _np(tv))


def test_build_pyramid_quantized_matches_jax():
    """``quantize=True`` rounds each level below the input to the uint8 grid
    (half to even on both sides). The levels are integers, and equal to the
    JAX levels but where the blur's float rounding differs by an ulp at a
    half: 1 grey level at those pixels, at most 0.1 % of them. The gradient
    pyramid likewise."""
    img = np.round(np.random.default_rng(4).uniform(0, 255, (61, 83)))
    jp = j_build_pyramid(jnp.asarray(img, jnp.float32), 4, quantize=True)
    tp = build_pyramid(torch.from_numpy(img.astype(np.float32)), 4, quantize=True)
    plain = build_pyramid(torch.from_numpy(img.astype(np.float32)), 4)
    for lv in range(4):
        for jx, tx in ((jp.images[lv], tp.images[lv]), (jp.gradients[lv], tp.gradients[lv])):
            t, j = _np(tx), np.asarray(jx)
            assert t.shape == j.shape
            np.testing.assert_array_equal(t, np.round(t))
            assert np.abs(t - j).max() <= 1.0 and (t != j).mean() <= 1e-3, lv
    assert not np.array_equal(_np(plain.images[2]), _np(tp.images[2]))


def _pyramids_and_features(levels=3):
    _, images, _ = make_sequence(np.random.default_rng(7), n_frames=2)
    jpyr = [j_build_pyramid(jnp.asarray(im, jnp.float64), levels) for im in images]
    tpyr = [build_pyramid(torch.from_numpy(np.asarray(im, np.float64)), levels) for im in images]
    uu, vv = np.meshgrid(np.linspace(20, 300, 15), np.linspace(20, 220, 10))
    return jpyr, tpyr, np.stack([uu.ravel(), vv.ravel()], -1)


def test_bootstrap_without_ba_matches_jax():
    """``run_ba=False``: the scaled RANSAC pose and triangulation, no two-view
    BA. Frames 0 and 1 of the ridge dolly, 150 grid features, the same RANSAC
    draws (the JAX key's uniforms). The same inliers; the pose and points in
    float64 to 1e-6 (KLT's subpixel flow agrees to ~1e-9 px); the median
    depth is the unscaled triangulation's, the minimum depth the scaled
    map's. With the BA on, the result differs."""
    jpyr, tpyr, uv = _pyramids_and_features()
    key = jax.random.PRNGKey(3)
    jcam = JCamera.create(**CAM, dtype=jnp.float64)
    tcam = PinholeCamera.create(**CAM, dtype=torch.float64)
    kw = dict(min_disparity=2.0, min_inliers=30)
    j = j_bootstrap_two_view(jpyr[0], jpyr[1], uv, jcam, key, run_ba=False, **kw)
    uniforms = torch.tensor(np.asarray(jax.random.uniform(key, (256, len(uv)), dtype=jnp.float64)))
    t = bootstrap_two_view(tpyr[0], tpyr[1], torch.from_numpy(uv), tcam, uniforms=uniforms, run_ba=False,
                           **kw)
    assert j.success and t.success, (j.reason, t.reason)
    assert len(t.points_w) == len(j.points_w) >= 30
    np.testing.assert_allclose(t.uv_ref, j.uv_ref, atol=1e-9)
    np.testing.assert_allclose(t.uv_cur, j.uv_cur, atol=1e-6)
    np.testing.assert_allclose(t.T_cur_ref, j.T_cur_ref, atol=1e-6)
    np.testing.assert_allclose(t.points_w, j.points_w, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose([t.median_depth, t.min_depth], [j.median_depth, j.min_depth], rtol=1e-6)
    with_ba = bootstrap_two_view(tpyr[0], tpyr[1], torch.from_numpy(uv), tcam, uniforms=uniforms, **kw)
    assert with_ba.success and np.abs(with_ba.T_cur_ref - t.T_cur_ref).max() > 1e-6


class _State(NamedTuple):  # a stacked state as ``place`` takes one: leading axis the sequences
    frame_id: np.ndarray
    pose: np.ndarray


def _placement_jax(x):
    """The sequence rows each device holds of a JAX array: {device: rows}."""
    out = {}
    for s in x.addressable_shards:
        rows = range(x.shape[0])[s.index[0]] if s.index else range(x.shape[0])
        out[s.device.id] = (rows.start, rows.stop)
    return out


def test_multi_chunk_fn_axis_matches_jax():
    """``axis`` names the mesh axis the sequences are cut over. On a mesh of
    one 'seq' device by two 'shard' devices: with ``axis="shard"`` each of
    two sequences goes to a device of its own, states along axis 0 and
    images along axis 1, as the JAX ``place`` shards them; with ``axis="seq"``
    both stay together (JAX replicates them on each shard device); a name the
    mesh lacks raises in both packages."""
    S = 2
    state = _State(np.arange(S, dtype=np.int32), np.random.default_rng(0).normal(size=(S, 3, 3)))
    images = np.random.default_rng(1).normal(size=(2, S, 3, 4, 5)).astype(np.float32)
    j_mesh = j_make_vo_mesh(num_seq=1, num_shard=2, devices=jax.devices()[:2])
    mesh = make_vo_mesh(num_seq=1, num_shard=2, devices=["cpu"] * 2)
    assert mesh.axis_names == tuple(j_mesh.axis_names) == ("seq", "shard")
    jvo = JDeviceVO(JCamera.create(**CAM, dtype=jnp.float64), JSuperstepConfig(**_superstep_cfg(2)))
    tvo = DeviceVO(PinholeCamera.create(**CAM), SuperstepConfig(**_superstep_cfg(2)))
    for axis, groups in (("shard", [(0, 1), (1, 2)]), ("seq", [(0, 2)])):
        jfn = j_multi_chunk_fn(jvo, j_mesh, axis=axis)
        tfn = multi_chunk_fn(tvo, mesh, axis=axis)
        jplaced = jfn.place(_State(*map(jnp.asarray, state)))
        tplaced = tfn.place(_State(*map(torch.from_numpy, state)))
        jimg = jfn.place(jnp.asarray(images), images=True)
        timg = tfn.place(torch.from_numpy(images), images=True)
        assert len(tplaced) == len(timg) == len(groups)
        jrows = sorted(set(_placement_jax(jplaced[1]).values()))
        assert jrows == groups, (axis, jrows)
        for part, (a, b) in zip(tplaced, groups):
            np.testing.assert_array_equal(_np(part[1]), state[1][a:b])
        for part, (a, b) in zip(timg, groups):
            np.testing.assert_array_equal(_np(part), images[:, a:b])
        np.testing.assert_array_equal(_np(timg.gather()), images)
        assert np.asarray(jimg).shape == images.shape
    with pytest.raises(Exception):
        j_multi_chunk_fn(jvo, j_mesh, axis="time")
    with pytest.raises(ValueError, match="no axis 'time'"):
        multi_chunk_fn(tvo, mesh, axis="time")


def _align_problem(levels):
    """A plane at z = 10 seen from the reference (world) pose and from a
    moved one, 48 grid features with their points in the reference frame."""
    ref, cur, _ = _pair(0, [0.03, -0.01, 0.02, 0.002, -0.003, 0.004])
    fx, fy, cx, cy = (CAM[k] for k in ("fx", "fy", "cx", "cy"))
    uu, vv = np.meshgrid(np.linspace(40, 280, 8), np.linspace(40, 200, 6))
    uv = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)
    pts = (np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, np.ones(len(uv))], -1) * 10.0).astype(np.float32)
    valid = np.ones(len(uv), bool)
    valid[-1] = False
    pr = [build_pyramid(torch.from_numpy(x), levels) for x in (ref, cur)]
    return pr, uv, pts, valid, (fx, fy, cx, cy)


def _superstep_cfg(levels):
    return dict(period=3, levels=levels, patch_align=5, patch_fa=5, patch_filter=7, cell_size=24,
                max_matches=96, max_error=2.0, min_tracked=20, max_dropped=150, max_keyframes=7,
                max_promote=32, ba_points=256, ba_iterations=4, epipolar_steps=16, staleness=3,
                convergence_factor=0.01, grad_threshold=20.0)


def test_device_vo_align_settings_match_jax():
    """``DeviceVO(align_settings=...)``: 7 iterations at the coarsest level,
    tapered by 2 a level (5, 7 over two levels) and an exit at 5e-3, given
    to both packages' ``DeviceVO``; the frame step's alignment
    (``align_precomputed``) against the JAX aligner on the kernels
    (``backend="pallas"``, K1 in interpret mode). The two poses put every
    feature within 0.01 px of each other, the tolerance of
    ``test_align_two_hosts_matches_pallas_backend``; the default settings
    give another pose."""
    levels = 2
    settings = dict(mad="hist", min_rel_decrease=5e-3, max_iterations=7)
    (pr, pc), uv, pts, valid, (fx, fy, cx, cy) = _align_problem(levels)
    jcam = JCamera.create(**CAM, dtype=jnp.float64)
    tcam = PinholeCamera.create(**CAM)
    jvo = JDeviceVO(jcam, JSuperstepConfig(**_superstep_cfg(levels)), align_settings=JLMSettings(**settings),
                    backend="pallas")
    tvo = DeviceVO(tcam, SuperstepConfig(**_superstep_cfg(levels)), align_settings=LMSettings(**settings))
    default = DeviceVO(tcam, SuperstepConfig(**_superstep_cfg(levels)))
    for field in ("max_iterations", "min_rel_decrease", "mad", "freeze_sigma"):
        assert getattr(tvo.aligner.settings, field) == getattr(jvo.aligner.settings, field), field
    assert [tvo.aligner.level_iterations(lv) for lv in range(levels)] == [5, 7]
    assert default.aligner.settings == DeviceVO.DEFAULT_ALIGN_SETTINGS
    assert (DeviceVO.DEFAULT_ALIGN_SETTINGS.max_iterations,
            DeviceVO.DEFAULT_ALIGN_SETTINGS.min_rel_decrease) == (10, 2e-3)

    f32 = jnp.float32
    jfeats = JAlignFeatures(jnp.asarray(uv), jnp.zeros(len(uv), jnp.int32), jnp.asarray(pts), jnp.asarray(valid))
    tfeats = AlignFeatures(torch.from_numpy(uv), torch.zeros(len(uv), dtype=torch.int32), torch.from_numpy(pts),
                           torch.from_numpy(valid))
    jtabs = jvo.aligner.precompute_ref_windows(tuple(jnp.asarray(_np(x)) for x in pr.images), jfeats, f32(fx),
                                               f32(fy))
    jT, _, _ = jvo.aligner.align_precomputed(JSE3(jnp.eye(3, dtype=f32), jnp.zeros(3, f32)), jtabs,
                                          tuple(jnp.asarray(_np(x)) for x in pc.images), jfeats,
                                          f32(fx), f32(fy), f32(cx), f32(cy))

    def run(vo):
        tabs = vo.aligner.precompute_ref_windows(pr.images, tfeats, fx, fy)
        return vo.aligner.align_precomputed(SE3.identity(), tabs, pc.images, tfeats, fx, fy, cx, cy)[0]

    def project(R, t):
        p = pts.astype(np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
        return np.stack([fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy], -1)

    tT, dT = run(tvo), run(default)
    apart = np.abs(project(_np(tT.rotation), _np(tT.translation)) - project(jT.rotation, jT.translation)).max()
    assert apart < 0.01, apart
    assert np.abs(_np(dT.translation) - _np(tT.translation)).max() > 1e-6
