"""The port's four kernel functions (K1–K4) against the Pallas kernels they
replace, on the CPU: the JAX side runs each Pallas kernel in interpret mode,
the port's wrapper takes its plain PyTorch version because the tensors lie
on the CPU. Inputs are made with numpy from a seed and handed to both as
float32. ``test_torch_gpu.py`` holds each CUDA kernel against its plain
version on the card.

Tolerances: both sides are float32 with different summation orders, so an LM
that takes the same accept/reject path agrees to ~1e-5 in pose; 1e-4 per
pose entry, 1e-3 relative rmse and 1e-3 px in uv leave room for that and
still catch a changed step or branch.
"""

import jax.numpy as jnp
import numpy as np
import torch
from scipy.linalg import expm

from sdvo_tpu.geometry.se3 import SE3 as JSE3
from sdvo_tpu.ops.pallas_depth import depth_scores as j_depth_scores
from sdvo_tpu.ops.pallas_fa import fa_align_batch as j_fa_align_batch
from sdvo_tpu.ops.pallas_lm import lm_align_level as j_lm_align_level
from sdvo_tpu.ops.pallas_pose import pose_refine as j_pose_refine

from sdvo_tpu_torch.dataio.synthetic import render_plane, smooth_texture
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.interp import padded_patch_and_gradients
from sdvo_tpu_torch.image.pyramid import abs_gradient_saturated_sum
from sdvo_tpu_torch.ops import depth_scores, fa_align, lm_align, pose_refine, selfcheck
from sdvo_tpu_torch.ops.window_sampler import sample_windows_grad, window_gather

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240)


class _Pose:
    def __init__(self, T):
        self.rotation = T[:3, :3]
        self.translation = T[:3, 3]


def _se3_np(tau):
    xi = np.zeros((4, 4))
    w = tau[3:]
    xi[:3, :3] = [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
    xi[:3, 3] = tau[:3]
    return expm(xi)


def _pair(seed, tau):
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    tex = smooth_texture(rng, size=1024, blur=15)
    cam = SimpleNamespace(**CAM)
    T_cur = _se3_np(np.asarray(tau, np.float64))
    ref = render_plane(tex, cam, _Pose(np.eye(4)), 10.0)
    cur = render_plane(tex, cam, _Pose(T_cur), 10.0)
    return ref.astype(np.float32), cur.astype(np.float32), T_cur


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lm_problem(seed=0, n_side=(8, 4)):
    """One level-0 alignment problem, N = 32 features on a plane at z = 10."""
    ref, cur, T_cur = _pair(seed, [0.02, -0.01, 0.015, 0.002, -0.003, 0.004])
    us = np.linspace(40, 280, n_side[0])
    vs = np.linspace(40, 200, n_side[1])
    uu, vv = np.meshgrid(us, vs)
    uv = np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)
    fx, fy, cx, cy = (CAM[k] for k in ("fx", "fy", "cx", "cy"))
    b = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, np.ones(len(uv))], -1)
    pts = (b * 10.0).astype(np.float32)
    win_r, org_r, ok_r = window_gather(_t(ref), _t(uv), 16)
    patches, gx, gy, ok_s = sample_windows_grad(win_r, _t(uv) - org_r, 5)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    iz, iz2 = 1 / z, 1 / z**2
    row_u = np.stack([fx * iz, 0 * x, -fx * x * iz2, -fx * x * y * iz2, fx * (1 + x * x * iz2), -fx * y * iz], -1)
    row_v = np.stack([0 * x, fy * iz, -fy * y * iz2, -fy * (1 + y * y * iz2), fy * x * y * iz2, fy * x * iz], -1)
    J = gx.numpy()[..., None] * row_u[:, None] + gy.numpy()[..., None] * row_v[:, None]
    uv0 = np.stack([fx * x / z + cx, fy * y / z + cy], -1).astype(np.float32)
    win_c, org_c, ok_c = window_gather(_t(cur), _t(uv0), 16)
    vis = (ok_r & ok_s & ok_c).numpy()
    J = np.where(vis[:, None, None], J, 0).astype(np.float32)
    return (win_c.numpy(), patches.numpy(), J, pts, org_c.numpy(), vis, fx, fy, cx, cy)


def test_lm_align_level_matches_pallas():
    win, patches, J, pts, org, vis, fx, fy, cx, cy = _lm_problem()
    jT, jrmse, jit = j_lm_align_level(
        JSE3(jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)),
        *(jnp.asarray(a) for a in (win, patches, J, pts, org, vis)),
        *(jnp.float32(v) for v in (fx, fy, cx, cy)),
        patch=5, max_iters=10, min_rel_decrease=2e-3, interpret=True,
    )
    tT, trmse, tit = lm_align.lm_align_level(
        SE3.identity(), *(_t(a) for a in (win, patches, J, pts, org, vis)), fx, fy, cx, cy,
        patch=5, max_iters=10, min_rel_decrease=2e-3,
    )
    assert int(jit) >= 2 and int(tit) == int(jit)
    np.testing.assert_allclose(tT.rotation.numpy(), np.asarray(jT.rotation), atol=1e-4)
    np.testing.assert_allclose(tT.translation.numpy(), np.asarray(jT.translation), atol=1e-4)
    np.testing.assert_allclose(float(trmse), float(jrmse), rtol=1e-3)


def _fa_problem(seed=1, n=16):
    ref, cur, _ = _pair(seed, [0.012, -0.008, 0.0, 0.0, 0.0, 0.0])
    gref = abs_gradient_saturated_sum(_t(ref))
    gcur = abs_gradient_saturated_sum(_t(cur))
    rng = np.random.default_rng(seed)
    uv_ref = rng.uniform(40, [280, 200], size=(n, 2)).astype(np.float32)
    patch, gx, gy, ok = padded_patch_and_gradients(gref, _t(uv_ref), 5)
    uv_init = (uv_ref + rng.normal(0, 0.5, size=(n, 2))).astype(np.float32)
    win, org, ok_w = window_gather(gcur, _t(uv_init), 24)
    live = (ok & ok_w).numpy()
    live[-2:] = False
    return (win.numpy(), patch.numpy(), gx.numpy(), gy.numpy(), uv_init, org.numpy(), live)


def test_fa_align_batch_matches_pallas():
    args = _fa_problem()
    juv, jerr, jconv = j_fa_align_batch(*(jnp.asarray(a) for a in args), patch=5, max_iters=10,
                                        interpret=True)
    tuv, terr, tconv = fa_align.fa_align_batch(*(_t(a) for a in args), patch=5, max_iters=10)
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    assert np.asarray(jconv).sum() >= 8
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-3)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-3, atol=1e-4)


def _pose_problem(seed=2, n=40, outliers=4):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -3, 6], [4, 3, 18], size=(n, 3))
    T_true = _se3_np(np.asarray([0.05, -0.03, 0.08, 0.004, -0.006, 0.01]))
    p_cam = pts @ T_true[:3, :3].T + T_true[:3, 3]
    brg = p_cam / np.linalg.norm(p_cam, axis=-1, keepdims=True)
    brg += rng.normal(0, 5e-4, size=brg.shape)
    brg[:outliers] += rng.normal(0, 0.05, size=(outliers, 3))
    brg /= np.linalg.norm(brg, axis=-1, keepdims=True)
    valid = np.ones(n, bool)
    valid[-3:] = False
    return pts.astype(np.float32), brg.astype(np.float32), valid, T_true


def test_pose_refine_matches_pallas():
    pts, brg, valid, T_true = _pose_problem()
    jT, jrmse, jit = j_pose_refine(
        JSE3(jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)),
        jnp.asarray(pts), jnp.asarray(brg), jnp.asarray(valid), max_iters=8,
        min_rel_decrease=1e-3, interpret=True,
    )
    tT, trmse, tit = pose_refine.pose_refine(SE3.identity(), _t(pts), _t(brg), _t(valid),
                                             max_iters=8, min_rel_decrease=1e-3)
    assert int(tit) == int(jit)
    np.testing.assert_allclose(tT.rotation.numpy(), np.asarray(jT.rotation), atol=1e-4)
    np.testing.assert_allclose(tT.translation.numpy(), np.asarray(jT.translation), atol=1e-4)
    np.testing.assert_allclose(float(trmse), float(jrmse), rtol=1e-3)
    # and the polish moves most of the way to the true pose
    err = np.linalg.norm(tT.translation.numpy() - T_true[:3, 3])
    assert err < 0.2 * np.linalg.norm(T_true[:3, 3]), err


def _depth_problem(seed=3, F=16, K=16, P=7):
    rng = np.random.default_rng(seed)
    H, W = 120, 320
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    locs = rng.uniform(20, [W - 20, H - 20], (F * K, 2)).astype(np.float32)
    ref = rng.uniform(0, 255, (F, P * P)).astype(np.float32)
    win, org, _ = window_gather(_t(img), _t(locs), win_h=P + 5)
    cref = np.repeat(ref - ref.mean(-1, keepdims=True), K, axis=0)
    offs = (_t(locs) - org).numpy()
    return win.numpy(), cref.astype(np.float32), offs


def test_depth_scores_match_pallas():
    win, cref, offs = _depth_problem()
    R, WH, WW = win.shape
    jsc, jok = j_depth_scores(jnp.asarray(win.reshape(R, -1)), jnp.asarray(cref),
                              jnp.asarray(offs), patch=7, win_h=WH, win_w=WW, block=128,
                              interpret=True)
    tsc, tok = depth_scores.depth_scores(_t(win), _t(cref), _t(offs), patch=7)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # ZSSD sums 49 terms of magnitude ~100: float32 rounding ~1e-3 absolute
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5, atol=5e-3)


def test_wrappers_route_cpu_tensors_to_plain_versions():
    """On CPU tensors each wrapper returns exactly its plain version's result
    and launches nothing; only a CUDA tensor reaches a kernel."""
    mods = (lm_align, fa_align, pose_refine, depth_scores)
    before = [(m.launches, m.plain_cuda_calls) for m in mods]
    sizes = {"lm": 16, "fa": 8, "pose": 20, "depth_filters": 8}
    for name, kernel, plain in selfcheck.kernel_cases(torch.device("cpu"), sizes):
        assert selfcheck.agrees(name, kernel(), plain()) == (0.0, True), name
    assert [(m.launches, m.plain_cuda_calls) for m in mods] == before
