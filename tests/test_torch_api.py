"""The public helpers of the port that the main paths do not call, each
against its JAX counterpart on seeded inputs: one parametrised test a
module, one case a helper.

Float64 on both sides (the test configuration enables JAX's x64), compared
to 1e-10 absolute unless a case says otherwise; masks, counts, shapes and
integer fields exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.dataio import evaluate as j_evaluate
from sdvo_tpu.depth import epipolar as j_epipolar
from sdvo_tpu.features import detection as j_detection
from sdvo_tpu.features import ssc as j_ssc
from sdvo_tpu.geometry import camera as j_camera
from sdvo_tpu.geometry import robust as j_robust
from sdvo_tpu.geometry import se3 as j_se3
from sdvo_tpu.geometry import triangulation as j_triangulation
from sdvo_tpu.image import interp as j_interp
from sdvo_tpu.image.pyramid import build_pyramid as j_build_pyramid
from sdvo_tpu.mapping.device_map import DeviceMap as JDeviceMap
from sdvo_tpu.ops import window_sampler as j_window_sampler

from sdvo_tpu_torch.dataio import evaluate
from sdvo_tpu_torch.dataio.synthetic import smooth_texture
from sdvo_tpu_torch.depth import epipolar
from sdvo_tpu_torch.features import detection, ssc
from sdvo_tpu_torch.geometry import camera, robust, se3, triangulation
from sdvo_tpu_torch.image import interp
from sdvo_tpu_torch.image.pyramid import abs_gradient_saturated_sum, build_pyramid
from sdvo_tpu_torch.mapping.device_map import DeviceMap
from sdvo_tpu_torch.ops import window_sampler

ATOL = 1e-10
CAM = dict(fx=320.0, fy=310.0, cx=161.5, cy=118.25, width=320, height=240)
DIST = (-0.28, 0.07, 1e-3, -5e-4, 0.01)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _cams(dist=DIST):
    return (camera.PinholeCamera.create(**CAM, dist=dist, dtype=torch.float64),
            j_camera.PinholeCamera.create(**CAM, dist=dist, dtype=jnp.float64))


def _points(rng, n=50):
    return np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(2, 12, (n, 1))], -1)


def _poses(rng, n=4):
    tau = rng.normal(0, 0.3, (n, 6))
    T = se3.exp(_t(tau))
    return T, j_se3.SE3(jnp.asarray(_np(T.rotation)), jnp.asarray(_np(T.translation)))


# ------------------------------------------------------------------ camera
@pytest.mark.parametrize("helper", ["K", "invK", "undistort_normalized", "is_in_frame", "scaled",
                                    "project_with_distortion", "backproject_with_distortion",
                                    "projection_jacobian", "pose_projection_jacobian", "undistort_image"])
def test_camera_helpers_match_jax(helper):
    rng = np.random.default_rng(1)
    tc, jc = _cams()
    if helper == "K":
        _close(tc.K(torch.float64), jc.K())
    elif helper == "invK":
        _close(tc.invK(torch.float64), jc.invK())
        _close(tc.invK(torch.float64) @ tc.K(torch.float64), np.eye(3), atol=1e-12)
    elif helper == "undistort_normalized":
        xy = rng.uniform(-0.5, 0.5, (40, 2))
        _close(tc.undistort_normalized(_t(xy)), jc.undistort_normalized(jnp.asarray(xy)))
        # 20 iterations invert the distortion
        _close(tc.undistort_normalized(tc.distort_normalized(_t(xy)), iters=20), xy, atol=1e-8)
    elif helper == "is_in_frame":
        uv = rng.uniform(-10, 340, (200, 2))
        for boundary, level in ((0.0, 0), (3.0, 1), (2.5, 2)):
            np.testing.assert_array_equal(_np(tc.is_in_frame(_t(uv), boundary, level)),
                                          np.asarray(jc.is_in_frame(jnp.asarray(uv), boundary, level)))
    elif helper == "scaled":
        for level in (1, 2):
            t, j = tc.scaled(level), jc.scaled(level)
            assert (t.width, t.height) == (j.width, j.height)
            _close([t.fx, t.fy, t.cx, t.cy], [float(j.fx), float(j.fy), float(j.cx), float(j.cy)])
            assert t.dist == tc.dist
    elif helper == "project_with_distortion":
        p = _points(rng)
        _close(tc.project(_t(p), with_distortion=True), jc.project(jnp.asarray(p), with_distortion=True))
    elif helper == "backproject_with_distortion":
        uv = rng.uniform([10, 10], [310, 230], (50, 2))
        _close(tc.backproject(_t(uv), with_distortion=True), jc.backproject(jnp.asarray(uv), with_distortion=True))
    elif helper in ("projection_jacobian", "pose_projection_jacobian"):
        p = _points(rng, 20)
        fn_t, fn_j = getattr(camera, helper), getattr(j_camera, helper)
        got = fn_t(tc, _t(p))
        _close(got, fn_j(jc, jnp.asarray(p)))
        # and the derivative itself, by forward-mode autodiff
        if helper == "projection_jacobian":
            def uv_of(q):
                return tc.project(q[None])[0]
            at = [_t(q) for q in p]
            auto = torch.stack([torch.func.jacfwd(uv_of)(q) for q in at])
        else:
            def uv_of(xi, q):
                return tc.project(se3.exp(xi).apply(q)[None])[0]
            auto = torch.stack([torch.func.jacfwd(uv_of)(torch.zeros(6, dtype=torch.float64), _t(q)) for q in p])
        _close(got, auto, atol=1e-9)
    else:  # undistort_image
        img = (smooth_texture(rng, size=512, blur=9)[:240, :320]).astype(np.float32)
        t0, _ = _cams(dist=None)
        np.testing.assert_array_equal(camera.undistort_image(img, t0), img)
        _close(camera.undistort_image(img, tc), j_camera.undistort_image(img, jc), atol=1e-3)


# --------------------------------------------------------------------- se3
@pytest.mark.parametrize("helper", ["from_matrix", "as_matrix", "matrix3x4", "adjoint", "normalize",
                                    "batch_shape", "relative", "camera_center"])
def test_se3_helpers_match_jax(helper):
    rng = np.random.default_rng(2)
    T, J = _poses(rng)
    if helper == "from_matrix":
        M = _np(T.as_matrix())
        for m in (M, M[:, :3]):
            got, want = se3.SE3.from_matrix(_t(m)), j_se3.SE3.from_matrix(jnp.asarray(m))
            _close(got.rotation, want.rotation)
            _close(got.translation, want.translation)
    elif helper in ("as_matrix", "matrix3x4", "adjoint"):
        _close(getattr(T, helper)(), getattr(J, helper)())
        if helper == "adjoint":  # Ad(T) exp(xi) = T exp(xi) T⁻¹
            xi = _t(rng.normal(0, 0.1, (4, 6)))
            lhs = se3.exp(torch.einsum("nij,nj->ni", T.adjoint(), xi))
            rhs = T.compose(se3.exp(xi)).compose(T.inverse())
            _close(lhs.rotation, rhs.rotation, atol=1e-12)
            _close(lhs.translation, rhs.translation, atol=1e-12)
    elif helper == "normalize":
        noisy = _np(T.rotation) + rng.normal(0, 1e-3, (4, 3, 3))
        got = se3.SE3(_t(noisy), T.translation).normalize()
        want = j_se3.SE3(jnp.asarray(noisy), J.translation).normalize()
        _close(got.rotation, want.rotation)
        _close(got.rotation @ got.rotation.transpose(-1, -2), np.broadcast_to(np.eye(3), (4, 3, 3)), atol=1e-12)
    elif helper == "batch_shape":
        assert tuple(T.batch_shape) == tuple(J.batch_shape) == (4,)
        assert tuple(se3.SE3.identity().batch_shape) == ()
    elif helper == "relative":
        T2, J2 = _poses(rng)
        got, want = se3.relative(T, T2), j_se3.relative(J, J2)
        _close(got.rotation, want.rotation)
        _close(got.translation, want.translation)
    else:
        _close(se3.camera_center(T), j_se3.camera_center(J))


# ----------------------------------------------------------- triangulation
@pytest.mark.parametrize("helper", ["triangulate_dlt_homogeneous", "reprojection_error"])
def test_triangulation_helpers_match_jax(helper):
    rng = np.random.default_rng(3)
    tc, jc = _cams(dist=None)
    pts = _points(rng, 30)
    T, J = _poses(rng, 1)
    if helper == "triangulate_dlt_homogeneous":
        K = _np(tc.K(torch.float64))
        P_ref = K @ np.eye(4)[:3]
        P_cur = K @ _np(T.matrix3x4())[0]
        uv_ref = _np(tc.project(_t(pts)))
        uv_cur = _np(tc.project(T.apply(_t(pts))))
        got = triangulation.triangulate_dlt_homogeneous(_t(P_ref), _t(P_cur), _t(uv_ref), _t(uv_cur))
        _close(got, j_triangulation.triangulate_dlt_homogeneous(
            jnp.asarray(P_ref), jnp.asarray(P_cur), jnp.asarray(uv_ref), jnp.asarray(uv_cur)), atol=1e-8)
        _close(got, pts, atol=1e-7)
    else:
        uv_obs = rng.uniform([0, 0], [320, 240], (30, 2))
        T1 = se3.SE3(T.rotation[0], T.translation[0])
        J1 = j_se3.SE3(J.rotation[0], J.translation[0])
        _close(triangulation.reprojection_error(T1, tc, _t(pts), _t(uv_obs)),
               j_triangulation.reprojection_error(J1, jc, jnp.asarray(pts), jnp.asarray(uv_obs)), atol=1e-8)


# ------------------------------------------------ robust, evaluate, windows
@pytest.mark.parametrize("helper", ["masked_sigma", "masked_sigma_unmasked", "MAD_SCALE"])
def test_robust_helpers_match_jax(helper):
    rng = np.random.default_rng(4)
    x = rng.standard_t(3, 301)
    mask = rng.uniform(size=301) < 0.7
    if helper == "masked_sigma":
        _close(robust.masked_sigma(_t(x), _t(mask)), j_robust.masked_sigma(jnp.asarray(x), jnp.asarray(mask)))
    elif helper == "masked_sigma_unmasked":
        _close(robust.masked_sigma(_t(x), k=2.0), j_robust.masked_sigma(jnp.asarray(x), k=2.0))
    else:
        assert robust.MAD_SCALE == j_robust.MAD_SCALE


@pytest.mark.parametrize("helper", ["rpe_zero_for_identical", "rpe"])
def test_evaluate_helpers_match_jax(helper):
    rng = np.random.default_rng(5)
    poses = np.stack([np.eye(4)] * 6)
    poses[:, :3, 3] = np.arange(6)[:, None] * [1.0, 0.1, 0.0]
    if helper == "rpe_zero_for_identical":
        t_err, r_err = evaluate.rpe(poses, poses)
        assert t_err < 1e-12 and r_err < 1e-9
    else:
        T, _ = _poses(rng, 6)
        est = poses @ _np(T.as_matrix())
        for delta in (1, 2):
            np.testing.assert_allclose(evaluate.rpe(est, poses, delta), j_evaluate.rpe(est, poses, delta),
                                       rtol=1e-12)


@pytest.mark.parametrize("helper", ["extract_windows", "window_origins"])
def test_window_sampler_helpers_match_jax(helper):
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    uv = rng.uniform(-5, [85, 65], (40, 2)).astype(np.float32)
    got_o, got_ok = window_sampler.window_origins(_t(uv), 16, 80, 60)
    want_o, want_ok = j_window_sampler.window_origins(jnp.asarray(uv), 16, 80, 60)
    if helper == "window_origins":
        np.testing.assert_array_equal(_np(got_o), np.asarray(want_o))
        np.testing.assert_array_equal(_np(got_ok), np.asarray(want_ok))
        assert 0 < _np(got_ok).sum() < 40
    else:
        np.testing.assert_array_equal(_np(window_sampler.extract_windows(_t(img), got_o, 16)),
                                      np.asarray(j_window_sampler.extract_windows(jnp.asarray(img), want_o, 16)))


# ---------------------------------------------- epipolar, pyramid, map
@pytest.mark.parametrize("helper", ["zssd_score", "num_levels", "image_at", "gradient_at", "DeviceMap.empty"])
def test_depth_pyramid_map_helpers_match_jax(helper):
    rng = np.random.default_rng(7)
    if helper == "zssd_score":
        ref = rng.uniform(0, 255, (12, 49))
        cur = rng.uniform(0, 255, (12, 5, 49))
        _close(epipolar.zssd_score(_t(ref)[:, None], _t(cur)),
               j_epipolar.zssd_score(jnp.asarray(ref)[:, None], jnp.asarray(cur)), atol=1e-9)
    elif helper == "DeviceMap.empty":
        got = DeviceMap.empty(4, 6, 10, 25, (8, 9))
        want = JDeviceMap.empty(4, 6, 10, 25, (8, 9))
        assert got._fields == want._fields
        for name, a, b in zip(got._fields, got, want):
            assert _np(a).dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
    else:
        img = rng.uniform(0, 255, (64, 96)).astype(np.float32)
        tp, jp = build_pyramid(_t(img), 3), j_build_pyramid(jnp.asarray(img), 3)
        assert tp.num_levels == jp.num_levels == 3
        for lv in range(3):
            if helper == "image_at":
                assert tp.image_at(lv) is tp.images[lv]
                _close(tp.image_at(lv), jp.image_at(lv), atol=1e-3)
            elif helper == "gradient_at":
                assert tp.gradient_at(lv) is tp.gradients[lv]
                _close(tp.gradient_at(lv), jp.gradient_at(lv), atol=1e-3)


# ------------------------------------------------------- detection, ssc
@pytest.mark.parametrize("helper", ["FeatureType", "gradient_orientation", "gradient_magnitude_with_ssc",
                                    "detect_with_ssc", "detect_by_value", "have_native"])
def test_detection_helpers_match_jax(helper):
    rng = np.random.default_rng(8)
    img = smooth_texture(rng, size=256, blur=5)[:120, :160].astype(np.float32)
    grad = _np(abs_gradient_saturated_sum(_t(img)))
    if helper == "FeatureType":
        for k in ("CORNER", "EDGE", "DEFAULT"):
            assert getattr(detection.FeatureType, k) == getattr(j_detection.FeatureType, k)
        assert detection.DetectedFeatures._fields == j_detection.DetectedFeatures._fields
    elif helper == "gradient_orientation":
        uv = np.concatenate([rng.uniform(0, [160, 120], (40, 2)), [[0.0, 0.0], [159.0, 119.0]]])
        np.testing.assert_array_equal(detection.gradient_orientation(img, uv),
                                      j_detection.gradient_orientation(img, uv))
        assert detection.gradient_orientation(img, np.zeros((0, 2))).shape == (0,)
    elif helper in ("gradient_magnitude_with_ssc", "detect_with_ssc"):
        occ = np.zeros((4, 6), np.uint8)
        occ[1, 2] = 1
        if helper == "gradient_magnitude_with_ssc":
            got, got_occ = detection.gradient_magnitude_with_ssc(grad, 20, 120, 30, occ.copy())
            want, want_occ = j_detection.gradient_magnitude_with_ssc(grad, 20, 120, 30, occ.copy())
            np.testing.assert_array_equal(got_occ, want_occ)
        else:
            t_sel, j_sel = detection.FeatureSelection(160, 120, 30), j_detection.FeatureSelection(160, 120, 30)
            got, want = t_sel.detect_with_ssc(grad, 20, 120), j_sel.detect_with_ssc(grad, 20, 120)
            np.testing.assert_array_equal(t_sel.occupancy, j_sel.occupancy)
        assert len(got.uv) > 5
        for name in ("uv", "response", "angle", "ftype"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        empty, _ = detection.gradient_magnitude_with_ssc(np.zeros_like(grad), 20, 120, 30)
        assert all(len(x) == 0 for x in empty)
    elif helper == "detect_by_value":
        t_sel, j_sel = detection.FeatureSelection(160, 120, 20), j_detection.FeatureSelection(160, 120, 20)
        for s in (t_sel, j_sel):
            s.set_existing_features(np.asarray([[25.0, 30.0], [101.0, 77.0]]))
        got = t_sel.detect_by_value(_t(grad), 20.0)
        want = j_sel.detect_by_value(jnp.asarray(grad), 20.0)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        assert 0 < _np(got[2]).sum() < len(_np(got[2]))
    else:
        assert ssc.have_native() == j_ssc.have_native() is True


# ------------------------------------------------------------------ interp
@pytest.mark.parametrize("sampler", ["bilinear_sample", "unclamped", "shifted"])
def test_padded_patch_and_gradients_samplers_match_jax(sampler):
    """``padded_patch_and_gradients(sample_fn, centers, P)`` with three
    samplers: the callers' closure over ``bilinear_sample``, the unclamped
    ``bilinear_sample`` (centres near the border, where its corners wrap or
    give NaN: NaNs must stand where JAX has them) and ``bilinear_sample`` of
    the image moved by a sub-pixel shift."""
    rng = np.random.default_rng(5)
    img = smooth_texture(rng, size=64, blur=5)[:48, :56] * 255.0
    c = np.concatenate([rng.uniform(6, [50, 42], (12, 2)), rng.uniform(-2, 3, (4, 2)),
                        rng.uniform([52, 44], [57, 49], (4, 2))])
    shift = np.asarray([0.37, -1.21])
    fns = {
        "bilinear_sample": (lambda q: interp.bilinear_sample(_t(img), q),
                            lambda q: j_interp.bilinear_sample(jnp.asarray(img), q)),
        "unclamped": (lambda q: interp.bilinear_sample(_t(img), q, clamp=False),
                      lambda q: j_interp.bilinear_sample(jnp.asarray(img), q, clamp=False)),
        "shifted": (lambda q: interp.bilinear_sample(_t(img), q + _t(shift)),
                    lambda q: j_interp.bilinear_sample(jnp.asarray(img), q + jnp.asarray(shift))),
    }[sampler]
    got = interp.padded_patch_and_gradients(fns[0], _t(c), 5)
    want = j_interp.padded_patch_and_gradients(fns[1], jnp.asarray(c), 5)
    for a, b in zip(got[:3], want[:3]):
        _close(a, b)
    np.testing.assert_array_equal(_np(got[3]), np.asarray(want[3]))
    assert 0 < _np(got[3]).sum() < len(c)
    if sampler == "unclamped":
        assert np.isnan(_np(got[0])).any()


# ---------------------------------------------------------- device system
@pytest.mark.parametrize("ba_presolve", [None, 2])
def test_device_system_ba_presolve_matches_jax(ba_presolve):
    """``DeviceSystem``'s ``ba_presolve`` (structure-only passes of the
    windowed BA, the configuration's ``ba_structure_presolve`` by default)
    lands in the superstep's configuration as in the JAX ``DeviceSystem``,
    and the device BA runs them (``BASettings.structure_presolve``)."""
    from sdvo_tpu.config import load_config as j_load_config
    from sdvo_tpu.pipeline.device_system import DeviceSystem as JDeviceSystem

    import sdvo_tpu_torch.pipeline.device_system as ds_mod
    from sdvo_tpu_torch.config import load_config

    kw = {} if ba_presolve is None else {"ba_presolve": ba_presolve}
    got = ds_mod.DeviceSystem(load_config(), device="cpu", **kw)
    want = JDeviceSystem(j_load_config(), **kw)
    assert got.scfg.ba_presolve == want.scfg.ba_presolve == (ba_presolve or 0)
    seen = []

    def local_ba(*args, settings, **kwargs):
        seen.append(settings.structure_presolve)
        raise StopIteration

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ds_mod, "local_ba", local_ba)
        a = load_config().algorithm
        m = DeviceMap.empty(a.max_keyframes, a.max_features_per_frame, a.max_points, 25)
        with pytest.raises(StopIteration):
            got.vo._run_ba(m, torch.tensor(0), torch.tensor(False))
    assert seen == [ba_presolve or 0]
