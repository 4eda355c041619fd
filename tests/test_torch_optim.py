"""The port's portable optimizers against the JAX package on the CPU:
``optim.optimizer`` (``tukey_weights``, ``_solve_damped``, ``optimize_lm``
with the three damping methods, ``optimize_gn``), ``optim.estimators`` and
the single-frame / windowed optimizers of ``ba.bundle_adjustment`` that sit
on them (``optimize_pose``, ``pose_covariance``, ``optimize_structure``,
``three_view_ba``, ``one_frame_with_scene``, ``optimize_scene``, ``local_ba``
with ``const_pt`` and the structure pre-solve).

Inputs are made with numpy from a seed and go through both packages in the
same dtype. Both sides compute the same formulas in the same order, so the
tolerances are those of another association order in the reductions:
float64 1e-9, float32 1e-4 (stated again per test where they differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.ba import bundle_adjustment as jba
from sdvo_tpu.geometry import se3 as jse3
from sdvo_tpu.optim import estimators as jest
from sdvo_tpu.optim import optimizer as jopt

from sdvo_tpu_torch.ba import bundle_adjustment as tba
from sdvo_tpu_torch.geometry import se3
from sdvo_tpu_torch.optim import estimators as test_
from sdvo_tpu_torch.optim import optimizer as topt

from test_torch_modules import _ba_scene, _np, _se3_np, _t

torch.set_num_threads(2)

TOL = {np.float64: 1e-9, np.float32: 1e-4}
DTYPES = [np.float64, np.float32]


# ------------------------------------------------------------ weights, solve
@pytest.mark.parametrize("mad", ["exact", "hist"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tukey_weights_match_jax(mad, dtype):
    g = np.random.default_rng(1)
    r = (g.normal(0, 2.0, 400) + (g.random(400) < 0.1) * 30.0).astype(dtype)
    vis = g.random(400) > 0.2
    jw = jopt.tukey_weights(jnp.asarray(r), jnp.asarray(vis), mad)
    tw = topt.tukey_weights(_t(r), _t(vis), mad)
    np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=TOL[dtype])
    assert (_np(tw)[~vis] == 0).all() and (_np(tw) == 0).sum() > (~vis).sum()  # outliers cut
    sig = np.asarray(1.0, dtype)
    np.testing.assert_allclose(_np(topt.tukey_weights(_t(r), _t(vis), mad, _t(sig))),
                               np.asarray(jopt.tukey_weights(jnp.asarray(r), jnp.asarray(vis), mad,
                                                             jnp.asarray(sig))), atol=TOL[dtype])


def _systems(dtype):
    """6×6 systems for ``_solve_damped``: positive definite (the relative
    ridge solves it), indefinite by a little (only the strong ridge does) and
    indefinite by much (neither: dx = 0); and a 10×10 pair for the library
    route (definite, and indefinite by less than the trace jitter, which then
    decides)."""
    g = np.random.default_rng(2)
    A = g.normal(size=(40, 6))
    H = A.T @ A
    Q, _ = np.linalg.qr(g.normal(size=(6, 6)))
    little = Q @ np.diag([5.0, 4.0, 3.0, 2.0, 1.0, -1e-4]) @ Q.T
    much = Q @ np.diag([5.0, 4.0, 3.0, 2.0, 1.0, -3.0]) @ Q.T
    B = g.normal(size=(30, 10))
    big = B.T @ B
    Q10, _ = np.linalg.qr(g.normal(size=(10, 10)))
    sing = Q10 @ np.diag([10.0, 9.0, 8.0, 7.0, 6.0, 5.0, 4.0, 3.0, 2.0, -2e-5]) @ Q10.T
    out = {"definite": H, "strong-ridge": little, "zero-step": much, "library": big,
           "library-jitter": sing}
    return {k: (v.astype(dtype), g.normal(size=v.shape[0]).astype(dtype)) for k, v in out.items()}


# the jittered 10×10 system has a condition number of ~3e5: float64 only
SOLVE_CASES = [(c, d) for d in DTYPES for c in ("definite", "strong-ridge", "zero-step", "library")]
SOLVE_CASES.append(("library-jitter", np.float64))


@pytest.mark.parametrize("case,dtype", SOLVE_CASES)
def test_solve_damped_matches_jax(case, dtype):
    """Both fall-backs of the unrolled solve and of the library route:
    float64 1e-9, float32 1e-4, relative to the largest component."""
    H, g = _systems(dtype)[case]
    jdx = np.asarray(jopt._solve_damped(jnp.asarray(H), jnp.asarray(g)))
    tdx = _np(topt._solve_damped(_t(H), _t(g)))
    assert tdx.dtype == dtype
    scale = max(np.abs(jdx).max(), 1.0)
    np.testing.assert_allclose(tdx, jdx, atol=TOL[dtype] * scale)
    if case == "zero-step":
        assert (tdx == 0).all()
    else:
        assert np.abs(tdx).max() > 0
    if case == "strong-ridge":  # the relative ridge alone leaves the system indefinite
        assert np.linalg.eigvalsh(H.astype(np.float64) + np.diag(1e-7 * np.diag(H))).min() < 0


# ------------------------------------------------------------- optimize_lm
def _curve_problem(dtype, seed=3, n=120):
    """y = a·exp(b·x) + c with noise and 10 % gross outliers; every sixth
    sample invisible."""
    g = np.random.default_rng(seed)
    x = np.linspace(0.0, 2.0, n)
    y = 2.0 * np.exp(-1.3 * x) + 0.5 + g.normal(0, 0.01, n)
    y[g.random(n) < 0.1] += 1.5
    vis = np.ones(n, bool)
    vis[::6] = False
    return x.astype(dtype), y.astype(dtype), vis, np.asarray([1.0, -0.5, 0.0], dtype)


def _curve_fns(xp, x, y, vis, where, stack, exp):
    def residual_fn(p):
        r = p[0] * exp(p[1] * x) + p[2] - y
        return where(vis, r, r * 0), vis

    def jacobian_fn(p):
        e = exp(p[1] * x)
        return stack([e, p[0] * x * e, e * 0 + 1], -1)

    return residual_fn, jacobian_fn, (lambda p, dx: p - dx)


@pytest.mark.parametrize("method", ["nielsen", "marquardt", "quadratic"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_optimize_lm_matches_jax(method, dtype):
    """The same iterates on both sides: parameters, rmse and status after up
    to 20 iterations with the relative-decrease exit, for each damping
    method. float64 1e-9; float32 5e-4 (accept/reject decisions are the same,
    the sums differ by rounding)."""
    x, y, vis, p0 = _curve_problem(dtype)
    jf = _curve_fns(jnp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(vis), jnp.where, jnp.stack, jnp.exp)
    tf = _curve_fns(torch, _t(x), _t(y), _t(vis), torch.where, torch.stack, torch.exp)
    for min_rel in (0.0, 1e-3):
        js = jopt.LMSettings(method=method, min_rel_decrease=min_rel)
        ts = topt.LMSettings(method=method, min_rel_decrease=min_rel)
        jp, jr, jst = jopt.optimize_lm(jnp.asarray(p0), *jf, js)
        tp, tr, tst = topt.optimize_lm(_t(p0), *tf, ts)
        tol = 1e-9 if dtype == np.float64 else 5e-4
        np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=tol)
        np.testing.assert_allclose(float(tr), float(jr), atol=tol)
        assert int(tst) == int(jst)
        assert tp.dtype == _t(p0).dtype
        if method != "quadratic":  # the line-fit damping stalls early on this curve, on both sides
            np.testing.assert_allclose(_np(tp), [2.0, -1.3, 0.5], atol=0.05)


@pytest.mark.parametrize("estimator", ["tukey", "huber", "cauchy"])
def test_optimize_lm_estimators_and_frozen_sigma_match_jax(estimator):
    x, y, vis, p0 = _curve_problem(np.float64, seed=4)
    jf = _curve_fns(jnp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(vis), jnp.where, jnp.stack, jnp.exp)
    tf = _curve_fns(torch, _t(x), _t(y), _t(vis), torch.where, torch.stack, torch.exp)
    kw = dict(estimator=estimator, mad="hist", freeze_sigma=True, max_iterations=12)
    jp, jr, jst = jopt.optimize_lm(jnp.asarray(p0), *jf, jopt.LMSettings(**kw))
    tp, tr, tst = topt.optimize_lm(_t(p0), *tf, topt.LMSettings(**kw))
    np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=1e-9)
    np.testing.assert_allclose(float(tr), float(jr), atol=1e-9)
    assert int(tst) == int(jst)


def test_optimize_lm_status_codes_match_jax():
    """A start at the optimum of a noise-free problem stops on the small
    step, a lambda outside its bounds on the lambda gate: same status."""
    x = np.linspace(0.0, 2.0, 50)
    y = 2.0 * np.exp(-1.3 * x) + 0.5
    vis = np.ones(50, bool)
    jf = _curve_fns(jnp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(vis), jnp.where, jnp.stack, jnp.exp)
    tf = _curve_fns(torch, _t(x), _t(y), _t(vis), torch.where, torch.stack, torch.exp)
    for p0, kw, want in (([2.0, -1.3, 0.5], dict(), topt.OptimizerStatus.SMALL_STEP),
                         ([1.0, -0.5, 0.0], dict(init_lambda=1e-20), topt.OptimizerStatus.LAMBDA_BOUND)):
        p0 = np.asarray(p0)
        _, _, jst = jopt.optimize_lm(jnp.asarray(p0), *jf, jopt.LMSettings(**kw))
        _, _, tst = topt.optimize_lm(_t(p0), *tf, topt.LMSettings(**kw))
        assert int(tst) == int(jst) == want


def test_optimize_lm_refuses_the_diagnostics_sink():
    """Named for the time the port refused ``LMSettings.visualize``; it now
    emits the post-solve diagnostics as the JAX package does: each sink gets
    the tag and the final residuals, weights, visibility and JᵀWJ, equal to
    the JAX package's within 1e-9 (float64)."""
    import jax

    x, y, vis, p0 = _curve_problem(np.float64, seed=4)
    jf = _curve_fns(jnp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(vis), jnp.where, jnp.stack, jnp.exp)
    tf = _curve_fns(torch, _t(x), _t(y), _t(vis), torch.where, torch.stack, torch.exp)
    got = {}
    jopt.set_diagnostics_sink(lambda *a: got.setdefault("jax", a))
    topt.set_diagnostics_sink(lambda *a: got.setdefault("port", a))
    try:
        kw = dict(max_iterations=12, visualize=True, viz_tag="curve")
        jopt.optimize_lm(jnp.asarray(p0), *jf, jopt.LMSettings(**kw))
        jax.effects_barrier()
        topt.optimize_lm(_t(p0), *tf, topt.LMSettings(**kw))
    finally:
        jopt.set_diagnostics_sink(None)
        topt.set_diagnostics_sink(None)
    assert got["port"][0] == got["jax"][0] == "curve"
    for a, b in zip(got["port"][1:], got["jax"][1:]):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-9)


@pytest.mark.parametrize("dtype", DTYPES)
def test_optimize_gn_matches_jax(dtype):
    x, y, vis, _ = _curve_problem(dtype, seed=5)
    p0 = np.asarray([1.8, -1.1, 0.4], dtype)  # Gauss-Newton has no damping: start in the basin
    jf = _curve_fns(jnp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(vis), jnp.where, jnp.stack, jnp.exp)
    tf = _curve_fns(torch, _t(x), _t(y), _t(vis), torch.where, torch.stack, torch.exp)
    jp, jr, _ = jopt.optimize_gn(jnp.asarray(p0), *jf, jopt.LMSettings(max_iterations=6))
    tp, tr, _ = topt.optimize_gn(_t(p0), *tf, topt.LMSettings(max_iterations=6))
    tol = 1e-9 if dtype == np.float64 else 5e-4
    np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=tol)
    np.testing.assert_allclose(float(tr), float(jr), atol=tol)


@pytest.mark.parametrize("method", sorted(test_.MESTIMATORS))
def test_mestimator_weights_match_jax(method):
    """Each of the 15 weight functions, float64: 1e-12 relative."""
    g = np.random.default_rng(6)
    r = g.normal(0, 1.5, 200)
    mask = g.random(200) > 0.15
    jw = jest.mestimator_weights(jnp.asarray(r), method, jnp.asarray(mask))
    tw = test_.mestimator_weights(_t(r), method, _t(mask))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("alpha", [2.0, 1.0, 0.0, -2.0, -np.inf])
def test_barron_weights_match_jax(alpha):
    g = np.random.default_rng(7)
    r = g.normal(0, 1.5, 100)
    np.testing.assert_allclose(_np(test_.barron_weights(_t(r), alpha)),
                               np.asarray(jest.barron_weights(jnp.asarray(r), alpha)), rtol=1e-12)


# --------------------------------------------------- single-frame optimizers
def _pose_problem(dtype, seed=8, n=80):
    g = np.random.default_rng(seed)
    pts = g.uniform([-4, -3, 6], [4, 3, 18], size=(n, 3))
    T_true = _se3_np([0.05, -0.03, 0.08, 0.004, -0.006, 0.01])
    p_cam = pts @ T_true[:3, :3].T + T_true[:3, 3]
    brg = p_cam / np.linalg.norm(p_cam, axis=-1, keepdims=True) + g.normal(0, 5e-4, size=(n, 3))
    brg[:6] += g.normal(0, 0.05, size=(6, 3))
    brg /= np.linalg.norm(brg, axis=-1, keepdims=True)
    valid = np.ones(n, bool)
    valid[-4:] = False
    return pts.astype(dtype), brg.astype(dtype), valid, T_true


@pytest.mark.parametrize("dtype", DTYPES)
def test_optimize_pose_and_covariance_match_jax(dtype):
    """The bearing-residual pose LM from the identity and its covariance.
    float64: pose 1e-9, covariance 1e-9 relative. float32: pose 1e-4 (the
    residuals are ~5e-4, near float32's rounding of unit vectors)."""
    pts, brg, valid, T_true = _pose_problem(dtype)
    eye, zero = np.eye(3, dtype=dtype), np.zeros(3, dtype)
    jT, jr, jst = jba.optimize_pose(jse3.SE3(jnp.asarray(eye), jnp.asarray(zero)), jnp.asarray(pts),
                                    jnp.asarray(brg), jnp.asarray(valid))
    tT, tr, tst = tba.optimize_pose(se3.SE3(_t(eye), _t(zero)), _t(pts), _t(brg), _t(valid))
    tol = 1e-9 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(_np(tT.rotation), np.asarray(jT.rotation), atol=tol)
    np.testing.assert_allclose(_np(tT.translation), np.asarray(jT.translation), atol=tol)
    np.testing.assert_allclose(float(tr), float(jr), atol=tol)
    assert int(tst) == int(jst)
    assert tT.translation.dtype == _t(pts).dtype
    np.testing.assert_allclose(_np(tT.translation), T_true[:3, 3], atol=0.02)
    if dtype == np.float64:
        jc = jba.pose_covariance(jT, jnp.asarray(pts), jnp.asarray(brg), jnp.asarray(valid))
        tc = tba.pose_covariance(tT, _t(pts), _t(brg), _t(valid))
        np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=1e-7, atol=1e-9 * np.abs(np.asarray(jc)).max())


def _jobs(cam_idx, pt_idx, uv, valid):
    return jba.BAObservations(jnp.asarray(cam_idx, jnp.int32), jnp.asarray(pt_idx, jnp.int32),
                              jnp.asarray(uv), jnp.asarray(valid))


def _tobs(cam_idx, pt_idx, uv, valid):
    return tba.BAObservations(_t(cam_idx), _t(pt_idx), _t(uv), _t(valid))


INTR = (320.0, 320.0, 160.0, 120.0)


def _ba_compare(jout, tout):
    (jP, jpts, jchi_o, jchi), (tP, tpts, tchi_o, tchi) = jout, tout
    np.testing.assert_allclose(_np(tP.rotation), np.asarray(jP.rotation), atol=1e-8)
    np.testing.assert_allclose(_np(tP.translation), np.asarray(jP.translation), atol=1e-8)
    np.testing.assert_allclose(_np(tpts), np.asarray(jpts), atol=1e-7)
    np.testing.assert_allclose(_np(tchi_o), np.asarray(jchi_o), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(tchi), float(jchi), rtol=1e-8)


def test_optimize_structure_matches_jax():
    """Per-point Gauss-Newton over a point table, float64: 1e-9."""
    K, P = 4, 30
    R, t, pts, cam_idx, pt_idx, uv, valid = _ba_scene(13, K, P)
    table = tba.build_point_table(pt_idx, valid, P, max_obs=K)
    table[-2:] = -1  # two points without observations stay where they are
    jp = jba.optimize_structure(jnp.asarray(pts), jse3.SE3(jnp.asarray(R), jnp.asarray(t)),
                                _jobs(cam_idx, pt_idx, uv, valid), jnp.asarray(table), *INTR)
    tp = tba.optimize_structure(_t(pts), se3.SE3(_t(R), _t(t)), _tobs(cam_idx, pt_idx, uv, valid),
                                table, *INTR)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=1e-9)
    np.testing.assert_array_equal(_np(tp)[-2:], pts[-2:])
    assert np.abs(_np(tp)[:-2] - pts[:-2]).max() > 1e-3


def test_three_view_ba_matches_jax():
    """Two keyframes fixed, the newest frame free, landmarks constant."""
    R, t, pts, cam_idx, pt_idx, uv, valid = _ba_scene(14, 3, 40)
    s = dict(iterations=6)
    jout = jba.three_view_ba(jse3.SE3(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(pts),
                             _jobs(cam_idx, pt_idx, uv, valid), None, *INTR, settings=jba.BASettings(**s))
    tout = tba.three_view_ba(se3.SE3(_t(R), _t(t)), _t(pts), _tobs(cam_idx, pt_idx, uv, valid), *INTR,
                             settings=tba.BASettings(**s))
    _ba_compare(jout, tout)
    np.testing.assert_array_equal(_np(tout[1]), pts)  # const_pt: no landmark moved
    np.testing.assert_array_equal(_np(tout[0].translation)[:2], t[:2])
    assert np.abs(_np(tout[0].translation)[2] - t[2]).max() > 1e-4


def test_one_frame_with_scene_matches_jax():
    R, t, pts, cam_idx, pt_idx, uv, valid = _ba_scene(15, 4, 40)
    jout = jba.one_frame_with_scene(jse3.SE3(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(pts),
                                    _jobs(cam_idx, pt_idx, uv, valid), None, 2, *INTR,
                                    settings=jba.BASettings(iterations=6))
    tout = tba.one_frame_with_scene(se3.SE3(_t(R), _t(t)), _t(pts), _tobs(cam_idx, pt_idx, uv, valid),
                                    2, *INTR, settings=tba.BASettings(iterations=6))
    _ba_compare(jout, tout)
    np.testing.assert_array_equal(_np(tout[0].translation)[[0, 1, 3]], t[[0, 1, 3]])


def test_optimize_scene_matches_jax():
    R, t, pts, cam_idx, pt_idx, uv, valid = _ba_scene(16, 4, 40)
    jout = jba.optimize_scene(jse3.SE3(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(pts),
                              _jobs(cam_idx, pt_idx, uv, valid), None, *INTR,
                              settings=jba.BASettings(iterations=6))
    tout = tba.optimize_scene(se3.SE3(_t(R), _t(t)), _t(pts), _tobs(cam_idx, pt_idx, uv, valid), *INTR,
                              settings=tba.BASettings(iterations=6))
    _ba_compare(jout, tout)
    np.testing.assert_array_equal(_np(tout[0].translation), t)


def test_local_ba_structure_presolve_matches_jax():
    """Two structure-only passes before the joint solve, a constant point
    among the free ones."""
    K, P = 4, 40
    R, t, pts, cam_idx, pt_idx, uv, valid = _ba_scene(17, K, P)
    fixed_cam = np.array([True, True, False, False])
    fixed_pt = np.zeros(P, bool)
    fixed_pt[-2:] = True
    const_pt = np.zeros(P, bool)
    const_pt[:5] = True
    s = dict(iterations=5, structure_presolve=2)
    jout = jba.local_ba(jse3.SE3(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(pts),
                        _jobs(cam_idx, pt_idx, uv, valid), None, jnp.asarray(fixed_cam),
                        jnp.asarray(fixed_pt), *INTR, settings=jba.BASettings(**s),
                        const_pt=jnp.asarray(const_pt))
    tout = tba.local_ba(se3.SE3(_t(R), _t(t)), _t(pts), _tobs(cam_idx, pt_idx, uv, valid),
                        _t(fixed_cam), _t(fixed_pt), *INTR, settings=tba.BASettings(**s),
                        const_pt=_t(const_pt))
    _ba_compare(jout, tout)
    np.testing.assert_array_equal(_np(tout[1])[:5], pts[:5])
