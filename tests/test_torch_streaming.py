"""The port's streaming path against the JAX package on the CPU: the
samplers of ``image.stack``, the uncached ``align_features_2d`` and
``StreamingTracker``.

The JAX side runs the kernels' semantics, as the port does: the tracker's
aligner is ``SparseImageAlign(backend="pallas")`` (K1 in interpret mode) and
its feature alignment is ``align_features_2d_cached`` with
``backend="pallas"`` (K2 in interpret mode; on the CPU the JAX package would
take its XLA branch, which has no freeze per feature, as
``test_torch_system`` patches it inside ``reproject_map``). Depth scoring
has one semantics in both packages.

The JAX tracker runs once per module, frame by frame through its own
``_frame_step`` outside ``jit``: the jitted chunk rounds the interpreted K1
differently, and on this scene that alone moves frame 1's pose by 0.0935 px
of projected features (the tracker's LM sits near a stall test there, where
an ulp decides one more iteration). The port is compared frame by frame from
the JAX tracker's own state before the frame (``convert.from_numpy`` of its
``StreamCarry``), so that each frame is one frame's disagreement. Tolerances
are stated per test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdvo_tpu.align.feature_alignment as j_fa_mod
from sdvo_tpu.align.image_alignment import AlignFeatures as JAlignFeatures
from sdvo_tpu.align.image_alignment import SparseImageAlign as JSparseImageAlign
from sdvo_tpu.depth.filter import FilterBank as JFilterBank
from sdvo_tpu.geometry.se3 import SE3 as JSE3
from sdvo_tpu.image import stack as j_stack
from sdvo_tpu.image.pyramid import build_pyramid as j_build_pyramid
from sdvo_tpu.pipeline.streaming import StreamCarry as JStreamCarry
from sdvo_tpu.pipeline.streaming import StreamingTracker as JStreamingTracker

from sdvo_tpu_torch.align.feature_alignment import align_features_2d
from sdvo_tpu_torch.align.image_alignment import AlignFeatures, SparseImageAlign
from sdvo_tpu_torch.convert import from_numpy
from sdvo_tpu_torch.dataio.synthetic import render_plane_track, smooth_texture
from sdvo_tpu_torch.depth.filter import init_filters
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image import stack
from sdvo_tpu_torch.image.interp import bilinear_sample, extract_patches
from sdvo_tpu_torch.image.pyramid import abs_gradient_saturated_sum, build_pyramid
from sdvo_tpu_torch.pipeline.streaming import StreamCarry, StreamingTracker, StreamOutputs

torch.set_num_threads(2)

# the scene of tests/test_streaming.py
H, W = 120, 160
FX = FY = 120.0
CX, CY = W / 2.0, H / 2.0
PLANE_Z = 10.0
F = 5
DTAU = np.asarray([0.08, 0.01, 0.05, 0.001, 0.004, 0.0008])
N_FEATS, M, LEVELS = 64, 32, 3
C, P2 = 16, 49  # FilterBank.empty(16, 49) of the JAX test
N_SEEDED = 12  # of them seeded at the reference keyframe, so that K4 scores live rows

PX_GAP = 0.01  # largest gap between the two poses' projected features, px
RMSE_RTOL = 1e-2
# where K1's rounding takes the LM another way at a stall test (one frame of
# five here): measured 0.097 px and 7.3 % of rmse
LM_PATH_PX = 0.15
LM_PATH_RTOL = 0.10
FA_UV_ATOL = 1e-3  # the K2 parity test's tolerances (test_torch_kernels)
FA_STEP_PX = 0.05  # one late K2 step (ops.selfcheck)
FA_FLIP_SHARE = 0.10  # the JAX docstring's parity bound on fa_converged
# filter means where both sides updated: two-view triangulation at this
# parallax (0.08 m at 9 m) loses three digits of float32, so from the same
# pose and the same match the depths differ by up to 2.7e-3 (measured)
MU_RTOL = 1e-2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scene():
    """The JAX test's scene, with 2F frames rendered (the second F for the
    chunk-split test) and the filter bank seeded."""
    cam = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    sc = render_plane_track(np.random.default_rng(42), cam, DTAU, 2 * F, N_FEATS, C, PLANE_Z)
    patches, _ = extract_patches(torch.from_numpy(sc.ref), torch.from_numpy(sc.filter_uv), 7)
    sc.bank = init_filters(torch.from_numpy(sc.filter_uv), torch.from_numpy(sc.filter_bearing), patches, 0,
                           9.0, 4.0, 0, torch.from_numpy(np.arange(C) < N_SEEDED))
    assert sc.bank.ref_patch.shape == (C, P2)
    return sc


def _port_inputs(sc):
    pyr = build_pyramid(torch.from_numpy(sc.ref), LEVELS)
    feats = AlignFeatures(torch.from_numpy(sc.uv), torch.zeros(N_FEATS, dtype=torch.int32),
                          torch.from_numpy(sc.points), torch.ones(N_FEATS, dtype=torch.bool))
    return [im[None] for im in pyr.images], pyr.base_gradient, feats


def _tracker():
    return StreamingTracker(SparseImageAlign(patch_size=5, min_level=0, max_level=LEVELS - 1),
                            levels=LEVELS, device="cpu")


def _track(sc, images, T_init, T_prev, bank):
    host_pyr, host_grad0, feats = _port_inputs(sc)
    return _tracker().track_chunk(images, host_pyr, host_grad0, feats, feats.uv_host[:M],
                                  torch.ones(M, dtype=torch.bool), T_init, T_prev, bank, FX, FY, CX, CY, 0)


@pytest.fixture(scope="module")
def jax_run(scene):
    """The JAX tracker over the first F frames, frame by frame: the state
    before each frame, each frame's outputs (numpy) and the last state."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fa_mod, "align_features_2d_cached",
                   functools.partial(j_fa_mod.align_features_2d_cached, backend="pallas"))
        pyr = j_build_pyramid(jnp.asarray(scene.ref), LEVELS)
        tracker = JStreamingTracker(JSparseImageAlign(patch_size=5, min_level=0, max_level=LEVELS - 1,
                                                      backend="pallas"), levels=LEVELS)
        feats = JAlignFeatures(jnp.asarray(scene.uv), jnp.zeros(N_FEATS, jnp.int32), jnp.asarray(scene.points),
                               jnp.ones(N_FEATS, bool))
        eye = JSE3(jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32))
        carry = JStreamCarry(eye, eye, JFilterBank(*[jnp.asarray(_np(x)) for x in scene.bank]))
        f32 = np.float32
        states, outs = [], []
        for i in range(F):
            states.append(jax.device_get(carry))
            carry, out = tracker._frame_step(
                carry, jnp.asarray(scene.frames[i]), tuple(im[None] for im in pyr.images), pyr.base_gradient,
                feats, feats.uv_host[:M], jnp.ones(M, bool), f32(FX), f32(FY), f32(CX), f32(CY),
                jnp.asarray(0, jnp.int32))
            outs.append(jax.device_get(out))
    return states, outs, jax.device_get(carry)


def _projected(sc, R, t):
    p = sc.points.astype(np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    return np.stack([FX * p[:, 0] / p[:, 2] + CX, FY * p[:, 1] / p[:, 2] + CY], -1)


def _truth_gates(sc, rotations, translations):
    """The JAX test's gates: every frame within 0.06 m and 0.01 rad."""
    for i in range(len(translations)):
        T = sc.T_true[i]
        err = np.linalg.norm(np.asarray(translations[i], np.float64) - T[:3, 3])
        assert err < 0.06, f"frame {i}: |t_err| = {err}"
        R = np.asarray(rotations[i], np.float64)
        ang = np.arccos(np.clip((np.trace(R.T @ T[:3, :3]) - 1) / 2, -1, 1))
        assert ang < 0.01, f"frame {i}: rot err {ang}"


# ---------------------------------------------------------------- samplers
def _sampler_case(patch, seed=3, K=3, Hs=60, Ws=80):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (K, Hs, Ws)).astype(np.float32)
    inner = rng.uniform(patch, [Ws - patch, Hs - patch], (60, 2))
    band = rng.uniform(-2.0, [Ws + 2.0, Hs + 2.0], (140, 2))  # the border band and past it
    centers = np.concatenate([inner, band]).astype(np.float32)
    host = rng.integers(0, K, len(centers)).astype(np.int32)
    return imgs, centers, host


# the blends differ only in the order of their four products: measured
# 4.6e-5 at most on a [0, 255] image (three float32 ulps at 255); 1e-5 of
# the image's range would be 2.6e-3
SAMPLER_ATOL = 1e-4


@pytest.mark.parametrize("patch", [5, 7])
@pytest.mark.parametrize("which", ["sample_patches", "sample_patches_grad", "sample_patches_multi",
                                   "sample_patches_grad_multi"])
def test_samplers_match_jax(which, patch):
    """Each sampler against the JAX one on its ``PatchStack``, K = 3 hosts
    and centres in and around the border band: ``ok`` equal, values equal
    where ``ok`` to ``SAMPLER_ATOL``, finite everywhere."""
    imgs, centers, host = _sampler_case(patch)
    multi = which.endswith("multi")
    if multi:
        ps = j_stack.build_patch_stack_multi(jnp.asarray(imgs), patch)
        want = getattr(j_stack, which)(ps, jnp.asarray(host), jnp.asarray(centers))
        got = getattr(stack, which)(torch.from_numpy(imgs), torch.from_numpy(host),
                                    torch.from_numpy(centers), patch)
    else:
        c = centers.reshape(10, 20, 2)  # the single-image samplers take any leading shape
        want = getattr(j_stack, which)(j_stack.build_patch_stack(jnp.asarray(imgs[1]), patch), jnp.asarray(c))
        got = getattr(stack, which)(torch.from_numpy(imgs[1]), torch.from_numpy(c), patch)
    ok = np.asarray(want[-1])
    np.testing.assert_array_equal(_np(got[-1]), ok)
    assert 0 < ok.sum() < ok.size
    for g, w in zip(got[:-1], want[:-1]):
        g = _np(g)
        assert g.shape == np.asarray(w).shape and np.all(np.isfinite(g))
        np.testing.assert_allclose(g[ok], np.asarray(w)[ok], rtol=0, atol=SAMPLER_ATOL)


# ---------------------------------------------------- align_features_2d (K2)
def _fa_hosts(seed=5, K=3, size=160, n=M):
    """K host gradient images (crops of one texture at different offsets),
    the current frame's (another crop, moved by a sub-pixel shift), and n
    features per host index with initial positions 0.5 px off."""
    rng = np.random.default_rng(seed)
    tex = smooth_texture(rng, size=512, blur=11)
    tt = torch.from_numpy(tex)
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float64), np.arange(size, dtype=np.float64), indexing="ij")
    grid = np.stack([xx, yy], -1).reshape(-1, 2)

    def crop(o):
        vals, _ = bilinear_sample(tt, torch.from_numpy(grid + o))
        return abs_gradient_saturated_sum(vals.reshape(size, size)).numpy().astype(np.float32)

    offs = [np.array([100.0 + 7 * k, 100.0 + 4 * k]) for k in range(K)]
    o_cur = np.array([104.6, 102.3])
    hosts = np.stack([crop(o) for o in offs])
    cur = crop(o_cur)
    host = rng.integers(0, K, n).astype(np.int32)
    uv_ref = rng.uniform(10, size - 10, (n, 2))
    uv_ref[:3] = [[2.0, 50.0], [80.0, size - 3.0], [1.0, 1.0]]  # inside the image, not its border
    true = uv_ref + np.stack(offs)[host] - o_cur
    uv_init = (true + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-2:] = False
    return hosts, cur, uv_ref.astype(np.float32), uv_init, valid, host, true


def test_align_features_2d_matches_jax_kernel_composition():
    """``align_features_2d`` over three hosts against the JAX composition it
    replaces, ``sample_patches_grad_multi`` → ``align_features_2d_cached``
    with ``backend="pallas"`` (K2 in interpret mode), the border test as the
    JAX function makes it: ``converged`` equal, uv to 1e-3 px, rmse to
    1e-3 relative / 1e-4 (the K2 parity test's tolerances)."""
    hosts, cur, uv_ref, uv_init, valid, host, true = _fa_hosts()
    border = 5 // 2 + 2
    ps = j_stack.build_patch_stack_multi(jnp.asarray(hosts), 5)
    rp, gx, gy, _ = j_stack.sample_patches_grad_multi(ps, jnp.asarray(host), jnp.asarray(uv_ref))
    inside = ((uv_ref[:, 0] >= border) & (uv_ref[:, 1] >= border)
              & (uv_ref[:, 0] < cur.shape[1] - border) & (uv_ref[:, 1] < cur.shape[0] - border))
    juv, jerr, jconv = j_fa_mod.align_features_2d_cached(
        jnp.asarray(cur), rp, gx, gy, jnp.asarray(uv_init), jnp.asarray(valid & inside), 5, 10, backend="pallas")
    tuv, terr, tconv = align_features_2d(torch.from_numpy(hosts), torch.from_numpy(cur), torch.from_numpy(uv_ref),
                                         torch.from_numpy(uv_init), torch.from_numpy(valid),
                                         host_idx=torch.from_numpy(host))
    np.testing.assert_array_equal(_np(tconv), np.asarray(jconv))
    assert not _np(tconv)[:3].any() and not _np(tconv)[-2:].any()
    assert _np(tconv).sum() >= M // 2
    np.testing.assert_allclose(_np(tuv), np.asarray(juv), atol=FA_UV_ATOL)
    np.testing.assert_allclose(_np(terr), np.asarray(jerr), rtol=1e-3, atol=1e-4)
    # and it finds the shift
    conv = _np(tconv)
    assert np.abs(_np(tuv)[conv] - true[conv]).max() < 0.3


def _shifted_pair(rng, shift, size=240):
    tex = smooth_texture(rng, size=512, blur=11)
    ref = torch.from_numpy(tex[100:100 + size, 100:100 + size].copy())
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float64), np.arange(size, dtype=np.float64), indexing="ij")
    uv = np.stack([xx + shift[0], yy + shift[1]], axis=-1).reshape(-1, 2)
    cur, _ = bilinear_sample(torch.from_numpy(tex), torch.from_numpy(uv + 100.0))
    return abs_gradient_saturated_sum(ref), abs_gradient_saturated_sum(cur.reshape(size, size))


@pytest.mark.parametrize("case", ["recover_translation", "illumination_offset_tolerated",
                                  "invalid_features_masked", "border_features_not_converged"])
def test_feature_alignment_cases_through_the_port(case):
    """``tests/test_feature_alignment.py``'s four cases, their scenes and
    gates as there, run through the port's ``align_features_2d``."""
    rng = np.random.default_rng(42)
    if case == "recover_translation":
        shift = (1.2, -0.8)
        gref, gcur = _shifted_pair(rng, shift)
        uv_ref = torch.from_numpy(rng.uniform(30, 210, size=(40, 2)))
        uv_out, err, _ = align_features_2d(gref, gcur, uv_ref, uv_ref, torch.ones(40, dtype=torch.bool))
        d = np.linalg.norm(_np(uv_out) - (_np(uv_ref) - np.asarray(shift)), axis=-1)
        low_err = _np(err) < 3.0
        assert float(np.mean(low_err)) > 0.6, np.median(_np(err))
        assert float(np.mean(d[low_err] < 0.3)) > 0.9, (d[low_err], err)
    elif case == "illumination_offset_tolerated":
        shift = (0.9, 0.6)
        gref, gcur = _shifted_pair(rng, shift)
        uv_ref = torch.from_numpy(rng.uniform(30, 210, size=(30, 2)))
        uv_out, _, _ = align_features_2d(gref, gcur + 12.0, uv_ref, uv_ref, torch.ones(30, dtype=torch.bool))
        d = np.linalg.norm(_np(uv_out) - (_np(uv_ref) - np.asarray(shift)), axis=-1)
        assert float(np.mean(d < 0.3)) > 0.6, np.median(d)
    elif case == "invalid_features_masked":
        gref, gcur = _shifted_pair(rng, (1.0, 1.0))
        uv_ref = torch.tensor([[50.0, 50.0], [120.0, 80.0]], dtype=torch.float64)
        uv_out, _, conv = align_features_2d(gref, gcur, uv_ref, uv_ref, torch.tensor([True, False]))
        assert bool(conv[0]) and not bool(conv[1])
        np.testing.assert_allclose(_np(uv_out[1]), _np(uv_ref[1]), atol=1e-9)
    else:
        gref, gcur = _shifted_pair(rng, (1.0, 1.0))
        uv_ref = torch.tensor([[1.0, 1.0], [239.0, 239.0]], dtype=torch.float64)
        _, _, conv = align_features_2d(gref, gcur, uv_ref, uv_ref, torch.ones(2, dtype=torch.bool))
        assert not bool(conv[0]) and not bool(conv[1])


# ------------------------------------------------------------ the tracker
def test_tracker_matches_jax_frame_by_frame(scene, jax_run):
    """Each frame from the JAX tracker's state before it (``from_numpy`` of
    its ``StreamCarry``). Measured, gaps of projected features: 5.7e-6,
    7.9e-6, 1.8e-3, 4.7e-4 and 0.097 px. On frame 4 K1's float32 rounding
    (plain against interpreted) decides a stall test the other way, and the
    LM ends 0.097 px and 7.3 % of rmse away; the JAX aligner itself moves
    0.020 px on frame 2 when its pyramid changes by one ulp (the port's). So:

    - all but one frame agree as ``test_align_two_hosts_matches_pallas_backend``
      holds the aligner, within ``PX_GAP`` px and the rmse within
      ``RMSE_RTOL``; every frame within ``LM_PATH_PX`` and ``LM_PATH_RTOL``;
    - ``fa_converged`` differs on fewer than 10 % of the matches; where both
      converged, uv follows the pose (within ``LM_PATH_PX``), and on the
      frames whose poses agree, where the initial positions differ by up to
      their gap, the median feature lies within 1e-3 px (K2's tolerance) and
      none more than one K2 step (0.05 px) apart;
    - on the frames whose poses agree, the filters that both updated agree
      in mean to ``MU_RTOL``, and ``df_converged`` and the live set differ
      on at most one filter (a convergence test on the float32 variance)."""
    states, outs, last = jax_run
    close = 0
    for i in range(F):
        carry = from_numpy(states[i], "cpu")
        assert isinstance(carry, StreamCarry)
        got_carry, got = _track(scene, scene.frames[i:i + 1], carry.T_cur_ref, carry.T_prev_ref, carry.filters)
        want = outs[i]
        gap = np.abs(_projected(scene, _np(got.rotations[0]), _np(got.translations[0]))
                     - _projected(scene, want[0], want[1])).max()
        rmse_rel = abs(float(got.rmse[0]) / float(want[2]) - 1.0)
        assert gap < LM_PATH_PX and rmse_rel < LM_PATH_RTOL, (i, gap, rmse_rel)
        tc, jc = _np(got.fa_converged[0]), np.asarray(want[5])
        assert (tc != jc).mean() < FA_FLIP_SHARE, (i, tc, jc)
        both = tc & jc
        assert both.sum() >= M // 2
        uv_d = np.abs(_np(got.uv_refined[0])[both] - np.asarray(want[4])[both]).max(-1)
        assert uv_d.max() < LM_PATH_PX, (i, uv_d.max())
        if not (gap < PX_GAP and rmse_rel < RMSE_RTOL):
            continue
        close += 1
        assert np.median(uv_d) <= FA_UV_ATOL and uv_d.max() <= FA_STEP_PX, (i, uv_d)
        nxt = states[i + 1] if i + 1 < F else last
        before = _np(carry.filters.mu)
        mine, theirs = _np(got_carry.filters.mu), np.asarray(nxt.filters.mu)
        upd = (mine != before) & (theirs != before)
        assert upd.sum() >= 2, i
        np.testing.assert_allclose(mine[upd], theirs[upd], rtol=MU_RTOL)
        assert (_np(got.df_converged[0]) != np.asarray(want[6])).sum() <= 1, i
        assert (_np(got_carry.filters.valid) != np.asarray(nxt.filters.valid)).sum() <= 1, i
    assert close >= F - 1, close


def test_tracker_follows_the_trajectory(scene, jax_run):
    """The port's tracker over the chunk, and the JAX tracker's frames, both
    within the JAX test's gates of the truth; the final carry is the last
    frame's outputs; the outputs have the JAX tracker's fields, shapes and
    dtypes."""
    _, outs, _ = jax_run
    carry, got = _track(scene, scene.frames[:F], SE3.identity(), SE3.identity(), scene.bank)
    _truth_gates(scene, _np(got.rotations), _np(got.translations))
    _truth_gates(scene, [o[0] for o in outs], [o[1] for o in outs])
    np.testing.assert_array_equal(_np(carry.T_cur_ref.translation), _np(got.translations[-1]))
    np.testing.assert_array_equal(_np(carry.T_cur_ref.rotation), _np(got.rotations[-1]))
    np.testing.assert_array_equal(_np(carry.T_prev_ref.translation), _np(got.translations[-2]))
    assert isinstance(got, StreamOutputs) and got._fields == StreamOutputs._fields
    for name, mine, theirs in zip(got._fields, got, outs[0]):
        assert tuple(mine.shape) == (F,) + np.asarray(theirs).shape, name
        assert _np(mine).dtype == np.asarray(theirs).dtype, name


def test_two_chunks_equal_one(scene):
    """A chunk of 2F frames gives the bits of two chunks of F, the second
    starting from the first's carry."""
    eye = SE3.identity()
    whole_carry, whole = _track(scene, scene.frames, eye, eye, scene.bank)
    c1, o1 = _track(scene, scene.frames[:F], eye, eye, scene.bank)
    c2, o2 = _track(scene, scene.frames[F:], c1.T_cur_ref, c1.T_prev_ref, c1.filters)
    for name, a, b1, b2 in zip(whole._fields, whole, o1, o2):
        assert torch.equal(a, torch.cat([b1, b2])), name
    for a, b in zip(jax.tree_util.tree_leaves(whole_carry), jax.tree_util.tree_leaves(c2)):
        assert torch.equal(a, b)


def test_tracker_wants_the_card_by_default(monkeypatch):
    """``StreamingTracker`` runs on the CUDA card unless told otherwise, and
    raises where there is none; ``device="cpu"`` runs it here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingTracker(SparseImageAlign())
    assert StreamingTracker(SparseImageAlign(), device="cpu").device == torch.device("cpu")
