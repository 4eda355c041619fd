"""The port's modules (``sdvo_tpu_torch``) against their JAX counterparts on
the CPU, one test per module of the main path. Inputs are made with numpy
from a seed and handed to both sides in the same dtype; JAX runs its CPU
path (the feature-alignment call of ``reproject_device`` runs the Pallas
kernel in interpret mode, as the port follows the kernel's semantics).

Tolerances, stated per test: float64 geometry agrees to ~1e-12 (the same
formulas, other association order); float32 image maths to ~1e-5 relative of
values up to 255; iterative solvers to what their stopping rules leave.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.linalg import expm
from scipy.ndimage import correlate1d

from sdvo_tpu.ba.bundle_adjustment import BAObservations as JObs
from sdvo_tpu.ba.bundle_adjustment import BASettings as JBASettings
from sdvo_tpu.ba.bundle_adjustment import build_point_table as j_build_point_table
from sdvo_tpu.ba.bundle_adjustment import local_ba as j_local_ba
from sdvo_tpu.ba.bundle_adjustment import two_view_ba as j_two_view_ba
from sdvo_tpu.depth.epipolar import epipolar_search as j_epipolar_search
from sdvo_tpu.depth.filter import FilterBank as JFilterBank
from sdvo_tpu.depth.filter import update_filters as j_update_filters
from sdvo_tpu.features.detection import FeatureSelection as JFeatureSelection
from sdvo_tpu.features.detection import detect_gradient_by_value as j_detect
from sdvo_tpu.features.klt import pyramidal_klt as j_klt
from sdvo_tpu.geometry import se3 as jse3
from sdvo_tpu.geometry.camera import PinholeCamera as JCamera
from sdvo_tpu.geometry.essential import find_essential_ransac as j_ransac
from sdvo_tpu.image.interp import bilinear_sample as j_bilinear
from sdvo_tpu.image.interp import extract_patches as j_extract_patches
from sdvo_tpu.image.pyramid import build_pyramid as j_build_pyramid
from sdvo_tpu.mapping.device_map import DeviceMap as JDeviceMap
from sdvo_tpu.mapping.device_map import reproject_device as j_reproject
from sdvo_tpu.ops import window_sampler as jws

from sdvo_tpu_torch.ba.bundle_adjustment import (BAObservations, BASettings, build_point_table,
                                                  local_ba, two_view_ba)
from sdvo_tpu_torch.convert import to_numpy, vo_state_from_numpy
from sdvo_tpu_torch.dataio.synthetic import render_plane, smooth_texture
from sdvo_tpu_torch.depth.epipolar import epipolar_search
from sdvo_tpu_torch.depth.filter import FilterBank, update_filters
from sdvo_tpu_torch.features.detection import FeatureSelection, detect_gradient_by_value
from sdvo_tpu_torch.features.klt import pyramidal_klt
from sdvo_tpu_torch.geometry import se3
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.geometry.essential import find_essential_ransac
from sdvo_tpu_torch.image.interp import bilinear_sample, extract_patches, padded_patch_and_gradients
from sdvo_tpu_torch.image.pyramid import abs_gradient_saturated_sum, build_pyramid, pyr_down
from sdvo_tpu_torch.mapping.device_map import PointType, reproject_device
from sdvo_tpu_torch.ops import window_sampler as tws

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


class _Pose:
    def __init__(self, T):
        self.rotation = T[:3, :3]
        self.translation = T[:3, 3]


def _se3_np(tau):
    tau = np.asarray(tau, np.float64)
    xi = np.zeros((4, 4))
    w = tau[3:]
    xi[:3, :3] = [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
    xi[:3, 3] = tau[:3]
    return expm(xi)


def _plane_images(seed, taus, depth=10.0):
    """Float32 renders of one textured plane at ``depth`` under world→camera
    poses exp(tau) (320×240, f = 320)."""
    tex = smooth_texture(np.random.default_rng(seed), size=1024, blur=15)
    cam = SimpleNamespace(**CAM)
    Ts = [_se3_np(t) for t in taus]
    return [render_plane(tex, cam, _Pose(T), depth).astype(np.float32) for T in Ts], Ts


# --------------------------------------------------------------- geometry
def test_se3_matches_jax(rng):
    """exp/log/compose/inverse/apply in float64, including small angles and
    an angle near π (the log's special branch): 1e-10 absolute."""
    taus = rng.normal(0, 0.5, size=(16, 6))
    taus[0, 3:] = 1e-6
    taus[1, 3:] = [0.0, 0.0, np.pi - 1e-4]
    jT = jse3.exp(jnp.asarray(taus))
    tT = se3.exp(_t(taus))
    np.testing.assert_allclose(_np(tT.rotation), np.asarray(jT.rotation), atol=1e-10)
    np.testing.assert_allclose(_np(tT.translation), np.asarray(jT.translation), atol=1e-10)
    np.testing.assert_allclose(_np(se3.log(tT)), np.asarray(jse3.log(jT)), atol=1e-8)
    a, b = slice(0, 8), slice(8, 16)
    jA = jse3.SE3(jT.rotation[a], jT.translation[a])
    jB = jse3.SE3(jT.rotation[b], jT.translation[b])
    tA = se3.SE3(tT.rotation[a], tT.translation[a])
    tB = se3.SE3(tT.rotation[b], tT.translation[b])
    jC, tC = jA.compose(jB.inverse()), tA.compose(tB.inverse())
    np.testing.assert_allclose(_np(tC.rotation), np.asarray(jC.rotation), atol=1e-10)
    np.testing.assert_allclose(_np(tC.translation), np.asarray(jC.translation), atol=1e-10)
    pts = rng.normal(0, 5, size=(8, 3))
    np.testing.assert_allclose(_np(tC.apply(_t(pts))), np.asarray(jC.apply(jnp.asarray(pts))),
                               atol=1e-10)


def test_camera_matches_jax(rng):
    """project/backproject/normalized, float64: 1e-10 px."""
    jc = JCamera.create(**CAM, dtype=jnp.float64)
    tc = PinholeCamera.create(**CAM, dtype=torch.float64)
    pts = rng.uniform([-3, -2, 4], [3, 2, 20], size=(32, 3))
    uv = rng.uniform(0, [320, 240], size=(32, 2))
    np.testing.assert_allclose(_np(tc.project(_t(pts))), np.asarray(jc.project(jnp.asarray(pts))),
                               atol=1e-10)
    np.testing.assert_allclose(_np(tc.backproject(_t(uv))),
                               np.asarray(jc.backproject(jnp.asarray(uv))), atol=1e-12)
    np.testing.assert_allclose(_np(tc.normalized(_t(uv))),
                               np.asarray(jc.normalized(jnp.asarray(uv))), atol=1e-12)


# ----------------------------------------------------------------- image
def test_build_pyramid_matches_jax(rng):
    """Four levels of intensity and gradient, float32: the stride-2 conv and
    the reference's decimation matmuls sum the same five taps in another
    order, 1e-3 absolute on values up to 255."""
    img = rng.uniform(0, 255, size=(96, 131)).astype(np.float32)
    jp = j_build_pyramid(jnp.asarray(img), 4)
    tp = build_pyramid(_t(img), 4)
    for lv in range(4):
        np.testing.assert_allclose(_np(tp.images[lv]), np.asarray(jp.image_at(lv)), atol=1e-3)
        np.testing.assert_allclose(_np(tp.gradients[lv]), np.asarray(jp.gradient_at(lv)), atol=1e-3)


def test_pyr_down_matches_scipy_golden(rng):
    """The golden of tests/test_image.py: scipy's mirror-mode [1 4 6 4 1]/16
    blur decimated by 2 (float64, 1e-9), and ceil(n/2) output on odd sizes."""
    img = rng.uniform(0, 255, size=(64, 80))
    k = np.array([1, 4, 6, 4, 1]) / 16.0
    expected = correlate1d(correlate1d(img, k, axis=0, mode="mirror"), k, axis=1, mode="mirror")
    np.testing.assert_allclose(_np(pyr_down(_t(img))), expected[::2, ::2], atol=1e-9)
    assert tuple(pyr_down(_t(rng.uniform(0, 255, size=(37, 41)))).shape) == (19, 21)
    g = _np(abs_gradient_saturated_sum(_t(img)))
    want = np.zeros_like(img)
    want[1:-1, 1:-1] = np.minimum(np.abs(img[1:-1, 2:] - img[1:-1, :-2])
                                  + np.abs(img[2:, 1:-1] - img[:-2, 1:-1]), 255.0)
    np.testing.assert_allclose(g, want, atol=1e-9)


def test_interp_matches_jax(rng):
    """Bilinear samples and patch tables, float64: 1e-9; flags equal."""
    img = rng.uniform(0, 255, size=(40, 52))
    uv = rng.uniform(-2, [54, 42], size=(64, 2))
    jv, jok = j_bilinear(jnp.asarray(img), jnp.asarray(uv))
    tv, tok = bilinear_sample(_t(img), _t(uv))
    np.testing.assert_array_equal(_np(tok), np.asarray(jok))
    np.testing.assert_allclose(_np(tv)[_np(tok)], np.asarray(jv)[np.asarray(jok)], atol=1e-9)
    c = rng.uniform(4, [48, 36], size=(16, 2))
    jp, jpok = j_extract_patches(jnp.asarray(img), jnp.asarray(c), 7)
    tp, tpok = extract_patches(_t(img), _t(c), 7)
    np.testing.assert_array_equal(_np(tpok), np.asarray(jpok))
    np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=1e-9)
    from sdvo_tpu.image.interp import padded_patch_and_gradients as j_padded

    jt = j_padded(lambda q: j_bilinear(jnp.asarray(img), q), jnp.asarray(c), 5)
    tt = padded_patch_and_gradients(_t(img), _t(c), 5)
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-9)


def test_window_sampler_matches_jax(rng):
    """window_gather is a pure gather (exact); the samplers float32 at 1e-4."""
    img = rng.uniform(0, 255, size=(60, 83)).astype(np.float32)
    uv = rng.uniform(-3, [86, 63], size=(48, 2)).astype(np.float32)
    for win_h in (12, 16, 24):
        jw, jo, jok = jws.window_gather(jnp.asarray(img), jnp.asarray(uv), win_h)
        tw, to, tok = tws.window_gather(_t(img), _t(uv), win_h)
        np.testing.assert_array_equal(_np(tw), np.asarray(jw))
        np.testing.assert_array_equal(_np(to), np.asarray(jo))
        np.testing.assert_array_equal(_np(tok), np.asarray(jok))
    offs = (uv - _np(to)).astype(np.float32)
    jv, jok = jws.sample_windows(jnp.asarray(_np(tw)), jnp.asarray(offs), 5)
    tv, tok = tws.sample_windows(tw, _t(offs), 5)
    np.testing.assert_array_equal(_np(tok), np.asarray(jok))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=1e-4)
    jg = jws.sample_windows_grad(jnp.asarray(_np(tw)), jnp.asarray(offs), 5)
    tg = tws.sample_windows_grad(tw, _t(offs), 5)
    for a, b in zip(tg, jg):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        else:
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4)


# -------------------------------------------------------------- features
def test_detect_gradient_by_value_matches_jax(rng):
    """Max-per-cell detector on an integer-valued gradient image (many equal
    maxima, so the first-index tie rule is exercised) with an occupancy
    mask: exact."""
    grad = rng.integers(0, 40, size=(100, 130)).astype(np.float32)
    occ = rng.random((4, 5)) < 0.3
    ju, jr, jv = j_detect(jnp.asarray(grad), 20.0, 24, occupied=jnp.asarray(occ))
    tu, tr, tv = detect_gradient_by_value(_t(grad), 20.0, 24, occupied=_t(occ))
    np.testing.assert_array_equal(_np(tu), np.asarray(ju))
    np.testing.assert_array_equal(_np(tr), np.asarray(jr))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))


def test_detect_with_ssc_matches_jax():
    """Threshold → SSC → grid bucketing on a rendered gradient image, with
    existing features marked: the same pixels, in the same order."""
    (img,), _ = _plane_images(5, [np.zeros(6)])
    grad = _np(abs_gradient_saturated_sum(_t(img)))
    existing = np.asarray([[40.0, 40.0], [200.0, 120.0]])
    jsel = JFeatureSelection(320, 240, 24)
    tsel = FeatureSelection(320, 240, 24)
    jsel.set_existing_features(existing)
    tsel.set_existing_features(existing)
    jf = jsel.detect_with_ssc(grad, 20, 150)
    tf = tsel.detect_with_ssc(grad, 20, 150)
    assert len(tf.uv) >= 50
    np.testing.assert_array_equal(np.asarray(tf.uv), np.asarray(jf.uv))
    np.testing.assert_array_equal(tsel.occupancy, jsel.occupancy)


def test_klt_matches_jax():
    """Pyramidal KLT on a rendered pair (3 px shift), float64, both fed the
    same pyramid: tracks to 1e-6 px, status equal."""
    (ref, cur), _ = _plane_images(6, [np.zeros(6), [0.09, -0.03, 0.0, 0.0, 0.0, 0.0]])
    pr = j_build_pyramid(jnp.asarray(ref, jnp.float64), 3)
    pc = j_build_pyramid(jnp.asarray(cur, jnp.float64), 3)
    r_imgs = [np.asarray(pr.image_at(i)) for i in range(3)]
    c_imgs = [np.asarray(pc.image_at(i)) for i in range(3)]
    g = np.random.default_rng(6)
    uv = g.uniform(30, [290, 210], size=(40, 2))
    juv, jst, jerr = j_klt([jnp.asarray(x) for x in r_imgs], [jnp.asarray(x) for x in c_imgs],
                           jnp.asarray(uv), window=11, iterations=20)
    tuv, tst, terr = pyramidal_klt([_t(x) for x in r_imgs], [_t(x) for x in c_imgs], _t(uv),
                                   window=11, iterations=20)
    np.testing.assert_array_equal(_np(tst), np.asarray(jst))
    assert _np(tst).sum() >= 30
    np.testing.assert_allclose(_np(tuv), np.asarray(juv), atol=1e-6)
    np.testing.assert_allclose(_np(terr), np.asarray(jerr), atol=1e-6)


def test_ransac_with_shared_uniforms():
    """E-RANSAC on 120 correspondences (25 % outliers), float64: the port is
    handed the uniforms ``jax.random.uniform(key, (S, N))`` that the JAX
    function draws from ``key``, so hypotheses, inlier sets and counts are
    equal; E agrees up to sign at 1e-8."""
    g = np.random.default_rng(9)
    N, S = 120, 64
    pts = g.uniform([-4, -3, 6], [4, 3, 16], size=(N, 3))
    T = _se3_np([0.3, 0.05, 0.02, 0.01, -0.02, 0.005])
    pc = pts @ T[:3, :3].T + T[:3, 3]
    x_ref = pts[:, :2] / pts[:, 2:] + g.normal(0, 5e-4, size=(N, 2))
    x_cur = pc[:, :2] / pc[:, 2:] + g.normal(0, 5e-4, size=(N, 2))
    x_cur[:30] += g.normal(0, 0.05, size=(30, 2))
    mask = np.ones(N, bool)
    mask[-5:] = False
    thr = (1.0 / 320.0) ** 2
    key = jax.random.PRNGKey(3)
    jE, jin, jc = j_ransac(jnp.asarray(x_ref), jnp.asarray(x_cur), jnp.asarray(mask), key,
                           num_hypotheses=S, threshold=thr)
    uniforms = np.asarray(jax.random.uniform(key, (S, N), dtype=jnp.float64))
    tE, tin, tc = find_essential_ransac(_t(x_ref), _t(x_cur), _t(mask), uniforms=_t(uniforms),
                                        num_hypotheses=S, threshold=thr)
    np.testing.assert_array_equal(_np(tin), np.asarray(jin))
    assert int(tc) == int(jc) >= 60
    jE, tE = np.asarray(jE), _np(tE)
    np.testing.assert_allclose(tE * np.sign(np.sum(tE * jE)), jE, atol=1e-8)


# ---------------------------------------------------------------- BA
def _ba_scene(seed, K, P, noise=0.5):
    g = np.random.default_rng(seed)
    pts = g.uniform([-4, -3, 6], [4, 3, 16], size=(P, 3))
    Ts = [_se3_np([0.25 * k, 0.03 * k, 0.05 * k, 0.0, 0.01 * k, 0.0]) for k in range(K)]
    cams, pids, uvs = [], [], []
    for k, T in enumerate(Ts):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([320 * pc[:, 0] / pc[:, 2] + 160, 320 * pc[:, 1] / pc[:, 2] + 120], -1)
        cams.append(np.full(P, k))
        pids.append(np.arange(P))
        uvs.append(uv + g.normal(0, noise, size=uv.shape))
    cam_idx, pt_idx, uv = np.concatenate(cams), np.concatenate(pids), np.concatenate(uvs)
    valid = g.random(len(cam_idx)) > 0.1
    uv[:4] += 25.0  # gross outliers: the Huber weights and chi² see them
    R = np.stack([T[:3, :3] for T in Ts])
    t = np.stack([T[:3, 3] for T in Ts])
    # perturbed starting point
    t_init = t + g.normal(0, 0.02, size=t.shape) * (np.arange(K) >= 2)[:, None]
    pts_init = pts + g.normal(0, 0.05, size=pts.shape)
    return R, t_init, pts_init, cam_idx, pt_idx, uv, valid


def _ba_compare(jout, tout):
    (jP, jpts, jchi_o, jchi), (tP, tpts, tchi_o, tchi) = jout, tout
    np.testing.assert_allclose(_np(tP.rotation), np.asarray(jP.rotation), atol=1e-8)
    np.testing.assert_allclose(_np(tP.translation), np.asarray(jP.translation), atol=1e-8)
    np.testing.assert_allclose(_np(tpts), np.asarray(jpts), atol=1e-7)
    np.testing.assert_allclose(_np(tchi_o), np.asarray(jchi_o), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(tchi), float(jchi), rtol=1e-8)


def test_local_ba_matches_jax():
    """Windowed Schur LM, float64, 4 cameras (two fixed), 40 points (3
    fixed), 10 % dropped observations, 4 outliers; with the relative-decrease
    exit. The index_add fill-in and the one-hot matmul fill-in sum the same
    terms: poses 1e-8, points 1e-7, chi² 1e-8 relative."""
    K, P = 4, 40
    R, t, pts, cam_idx, pt_idx, uv, valid = _ba_scene(11, K, P)
    fixed_cam = np.array([True, True, False, False])
    fixed_pt = np.zeros(P, bool)
    fixed_pt[-3:] = True
    jout = j_local_ba(jse3.SE3(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(pts),
                      JObs(jnp.asarray(cam_idx, jnp.int32), jnp.asarray(pt_idx, jnp.int32),
                           jnp.asarray(uv), jnp.asarray(valid)),
                      None, jnp.asarray(fixed_cam), jnp.asarray(fixed_pt), 320.0, 320.0, 160.0, 120.0,
                      settings=JBASettings(iterations=6, min_rel_decrease=1e-3))
    tout = local_ba(se3.SE3(_t(R), _t(t)), _t(pts),
                    BAObservations(_t(cam_idx), _t(pt_idx), _t(uv), _t(valid)),
                    _t(fixed_cam), _t(fixed_pt), 320.0, 320.0, 160.0, 120.0,
                    settings=BASettings(iterations=6, min_rel_decrease=1e-3))
    _ba_compare(jout, tout)
    assert np.abs(_np(tout[0].translation)[2:] - t[2:]).max() > 1e-4  # the free cameras moved
    np.testing.assert_array_equal(build_point_table(pt_idx, valid, P, 3),
                                  j_build_point_table(pt_idx, valid, P, 3))


def test_two_view_ba_matches_jax():
    """First camera fixed, second and the points free, float64, 10 fixed
    iterations: as local_ba."""
    R, t, pts, cam_idx, pt_idx, uv, valid = _ba_scene(12, 2, 50)
    fixed_pt = np.zeros(50, bool)
    jout = j_two_view_ba(jse3.SE3(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(pts),
                         JObs(jnp.asarray(cam_idx, jnp.int32), jnp.asarray(pt_idx, jnp.int32),
                              jnp.asarray(uv), jnp.asarray(valid)),
                         None, jnp.asarray(fixed_pt), 320.0, 320.0, 160.0, 120.0,
                         settings=JBASettings(iterations=10))
    tout = two_view_ba(se3.SE3(_t(R), _t(t)), _t(pts),
                       BAObservations(_t(cam_idx), _t(pt_idx), _t(uv), _t(valid)),
                       _t(fixed_pt), 320.0, 320.0, 160.0, 120.0, settings=BASettings(iterations=10))
    _ba_compare(jout, tout)


# ------------------------------------------------------- depth filters
def _filter_problem(seed=4, C=24):
    """C filters seeded on a keyframe of a plane at z = 10 (mean depth
    guessed 20 % too far), a current frame 0.25 to the side, and the bank in
    numpy (float32)."""
    (ref, cur), Ts = _plane_images(seed, [np.zeros(6), [0.25, 0.02, 0.0, 0.0, 0.0, 0.0]])
    g = np.random.default_rng(seed)
    uv = g.uniform(30, [290, 210], size=(C, 2)).astype(np.float32)
    cam = PinholeCamera.create(**CAM)
    bearing = _np(cam.backproject(_t(uv)))
    patches, ok = extract_patches(_t(ref), _t(uv), 7)
    mu = np.full(C, 1.0 / 12.0, np.float32)
    max_inv = np.full(C, 1.0 / 4.0, np.float32)
    var = (max_inv / 6.0) ** 2
    valid = _np(ok).copy()
    valid[-2:] = False
    bank = dict(uv_ref=uv, bearing_ref=bearing.astype(np.float32),
                ref_patch=_np(patches).astype(np.float32), kf_slot=np.zeros(C, np.int32),
                mu=mu, var=var.astype(np.float32), a=np.full(C, 10.0, np.float32),
                b=np.full(C, 10.0, np.float32), max_inv_depth=max_inv,
                born_kf=np.zeros(C, np.int32), valid=valid)
    T = Ts[1]
    R = np.repeat(T[None, :3, :3], C, 0).astype(np.float32)
    t = np.repeat(T[None, :3, 3], C, 0).astype(np.float32)
    return bank, R, t, cur


def test_epipolar_search_window_path_matches_jax():
    """The window path of epipolar_search: JAX samples and scores with its
    XLA sampler on the CPU, the port with K4's plain version. Float32;
    matched flags equal, best positions 1e-3 px, depths 1e-3 relative: the
    two rays meet at ~1.4°, so the 2×2 normal equations of the triangulation
    lose ~3 of float32's 7 digits and another summation order moves the
    depth by ~2e-4 relative."""
    bank, R, t, cur = _filter_problem()
    sig = np.sqrt(bank["var"])
    args = (bank["ref_patch"], bank["bearing_ref"], bank["mu"], bank["mu"] + sig,
            np.maximum(bank["mu"] - sig, 1e-7), bank["valid"])
    jd, jm, juv = j_epipolar_search(jse3.SE3(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(cur),
                                    *(jnp.asarray(a) for a in args), 320.0, 320.0, 160.0, 120.0,
                                    patch_size=7, num_steps=16)
    td, tm, tuv = epipolar_search(se3.SE3(_t(R), _t(t)), _t(cur), *(_t(a) for a in args),
                                  320.0, 320.0, 160.0, 120.0, patch_size=7, num_steps=16)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    assert _np(tm).sum() >= 12
    m = np.asarray(jm)
    np.testing.assert_allclose(_np(td)[m], np.asarray(jd)[m], rtol=1e-3)
    np.testing.assert_allclose(_np(tuv)[m], np.asarray(juv)[m], atol=1e-3)


def test_update_filters_matches_jax():
    """One bank update (staleness, search, tau, Vogiatzis fusion,
    convergence), float32: flags equal, moments 1e-3 relative (the
    triangulated depth's conditioning, see the epipolar test)."""
    bank, R, t, cur = _filter_problem()
    bank["born_kf"][:3] = -7  # stale: dropped by the staleness rule
    jbank = JFilterBank(**{k: jnp.asarray(v) for k, v in bank.items()})
    tbank = FilterBank(**{k: _t(v) for k, v in bank.items()})
    jb, jconv = j_update_filters(jbank, jse3.SE3(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(cur),
                                 320.0, 320.0, 160.0, 120.0, kf_counter=jnp.int32(0),
                                 convergence_factor=4.0)
    tb, tconv = update_filters(tbank, se3.SE3(_t(R), _t(t)), _t(cur), 320.0, 320.0, 160.0, 120.0,
                               kf_counter=torch.tensor(0, dtype=torch.int32), convergence_factor=4.0)
    np.testing.assert_array_equal(_np(tconv), np.asarray(jconv))
    np.testing.assert_array_equal(_np(tb.valid), np.asarray(jb.valid))
    assert not _np(tb.valid)[:3].any()
    for f in ("mu", "var", "a", "b"):
        np.testing.assert_allclose(_np(getattr(tb, f)), np.asarray(getattr(jb, f)), rtol=1e-3,
                                   err_msg=f)
    assert (_np(tb.mu) != bank["mu"]).sum() >= 10


# ---------------------------------------------------------------- map
def _map_problem(seed=8, K=4, F=48, P=64):
    """A DeviceMap (numpy, float32) of a textured plane at z = 10 seen by two
    keyframes, half the points GOOD and half CANDIDATE, a few dead; the
    current frame's gradient image and its (slightly perturbed) pose."""
    taus = [np.zeros(6), [0.3, 0.0, 0.0, 0.0, 0.0, 0.0], [0.5, 0.05, 0.1, 0.0, 0.01, 0.0]]
    imgs, Ts = _plane_images(seed, taus)
    g = np.random.default_rng(seed)
    uv0 = g.uniform(30, [290, 210], size=(P, 2))
    pts = np.concatenate([(uv0 - [160, 120]) / 320.0, np.ones((P, 1))], 1) * 10.0
    grads = [abs_gradient_saturated_sum(_t(im)) for im in imgs]
    kf_R = np.tile(np.eye(3), (K, 1, 1))
    kf_t = np.zeros((K, 3))
    feat_uv = np.zeros((K, F, 2))
    feat_point = -np.ones((K, F), np.int32)
    feat_valid = np.zeros((K, F), bool)
    tabs = [np.zeros((K, F, 25), np.float32) for _ in range(3)]
    feat_ok = np.zeros((K, F), bool)
    half = P // 2
    for k in range(2):
        T = Ts[k]
        kf_R[k], kf_t[k] = T[:3, :3], T[:3, 3]
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([320 * pc[:, 0] / pc[:, 2] + 160, 320 * pc[:, 1] / pc[:, 2] + 120], -1)
        rows = np.arange(half) if k == 0 else np.arange(P - F, P)  # overlapping point sets
        n = len(rows)
        feat_uv[k, :n] = uv[rows]
        feat_point[k, :n] = rows
        feat_valid[k, :n] = True
        p, gx, gy, ok = padded_patch_and_gradients(grads[k], _t(uv[rows].astype(np.float32)), 5)
        for tab, val in zip(tabs, (p, gx, gy)):
            tab[k, :n] = _np(val)
        feat_ok[k, :n] = _np(ok)
    pt_type = np.where(np.arange(P) % 2 == 0, int(PointType.GOOD), int(PointType.CANDIDATE))
    pt_valid = np.ones(P, bool)
    pt_valid[5:8] = False
    pt_fail = np.zeros(P, np.int32)
    pt_fail[9] = 15  # moved out of view below: killed by this pass's failure
    pts[9] = [60.0, 0.0, 10.0]
    m = JDeviceMap(
        kf_R=kf_R.astype(np.float32), kf_t=kf_t.astype(np.float32),
        kf_valid=np.arange(K) < 2, kf_frame_id=np.array([0, 3, -1, -1], np.int32),
        kf_counter=np.int32(2), kf_img0=np.zeros((K, 4, 4), np.float32),
        feat_uv=feat_uv.astype(np.float32), feat_point=feat_point, feat_valid=feat_valid,
        feat_patch=tabs[0], feat_gx=tabs[1], feat_gy=tabs[2], feat_ok=feat_ok,
        pt_pos=pts.astype(np.float32), pt_type=pt_type.astype(np.int32), pt_valid=pt_valid,
        pt_succ=np.zeros(P, np.int32), pt_fail=pt_fail)
    T_cur = _se3_np(taus[2]) @ _se3_np([0.003, -0.002, 0.0, 0.0, 0.0005, 0.0])
    return m, T_cur.astype(np.float32), _np(grads[2])


def test_reproject_device_matches_jax():
    """One reprojection pass on a converted DeviceMap: visibility, close-view
    choice, hashed one-per-cell binning, the stable capacity cap, K2 and the
    point counters. JAX runs the Pallas feature-alignment kernel in interpret
    mode. Slots, flags and counters exact; uv 1e-3 px; rmse 1e-3 relative."""
    m, T, grad = _map_problem()
    jm = JDeviceMap(*[jnp.asarray(x) for x in m])
    tm = vo_state_from_numpy(m, device="cpu")
    kw = dict(cell_size=24, max_matches=32, max_error=50.0, patch_size=5)
    jm2, jmat = j_reproject(jm, jse3.SE3(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3])),
                            jnp.asarray(grad), jnp.float32(320.0), jnp.float32(320.0),
                            jnp.float32(160.0), jnp.float32(120.0),
                            frame_salt=jnp.int32(7), backend="pallas", **kw)
    tm2, tmat = reproject_device(tm, se3.SE3(_t(T[:3, :3]), _t(T[:3, 3])), _t(grad),
                                 320.0, 320.0, 160.0, 120.0,
                                 frame_salt=torch.tensor(7, dtype=torch.int32), **kw)
    np.testing.assert_array_equal(_np(tmat.pt_slot), np.asarray(jmat.pt_slot))
    np.testing.assert_array_equal(_np(tmat.good), np.asarray(jmat.good))
    assert int(tmat.n_good) == int(jmat.n_good) >= 16
    g = np.asarray(jmat.good)
    np.testing.assert_allclose(_np(tmat.uv)[g], np.asarray(jmat.uv)[g], atol=1e-3)
    np.testing.assert_allclose(_np(tmat.err)[g], np.asarray(jmat.err)[g], rtol=1e-3, atol=1e-4)
    tn = to_numpy(tm2)
    for f in ("pt_succ", "pt_fail", "pt_type", "pt_valid", "feat_valid"):
        np.testing.assert_array_equal(getattr(tn, f), np.asarray(getattr(jm2, f)), err_msg=f)
    assert not tn.pt_valid[9]
