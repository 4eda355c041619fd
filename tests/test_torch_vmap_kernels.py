"""The port's four kernel ops under ``torch.func.vmap`` against ``jax.vmap``
of the Pallas kernels they replace, on the CPU, at S = 2 stacked problems.

The multi-sequence path (``sdvo_tpu_torch.parallel``) batches each kernel
over a leading sequence axis: the JAX package by ``jax.vmap`` of each
``pallas_call`` (run here in interpret mode), the port by the vmap rule of
each custom op (``sdvo::lm_align_level`` and the others), which on CPU
tensors calls the plain version once per problem. The problems are
``test_torch_kernels``'s at two seeds; the tolerances are that file's: both
sides are float32 with different summation orders, so an LM that takes the
same accept/reject path agrees to ~1e-5 in pose; 1e-4 per pose entry, 1e-3
relative rmse and 1e-3 px in uv leave room for that and still catch a
changed step or branch; ZSSD scores to 5e-3 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sdvo_tpu.geometry.se3 import SE3 as JSE3
from sdvo_tpu.ops.pallas_depth import depth_scores as j_depth_scores
from sdvo_tpu.ops.pallas_fa import fa_align_batch as j_fa_align_batch
from sdvo_tpu.ops.pallas_lm import lm_align_level as j_lm_align_level
from sdvo_tpu.ops.pallas_pose import pose_refine as j_pose_refine

from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.ops import depth_scores, fa_align, lm_align, pose_refine

from test_torch_kernels import _depth_problem, _fa_problem, _lm_problem, _pose_problem

torch.set_num_threads(2)

S = 2
f32 = jnp.float32


def _stack(problems, k):
    return np.stack([p[k] for p in problems])


def _identities():
    return (JSE3(jnp.broadcast_to(jnp.eye(3, dtype=f32), (S, 3, 3)), jnp.zeros((S, 3), f32)),
            SE3.identity((S,)))


def test_vmapped_lm_align_level_matches_vmapped_pallas():
    problems = [_lm_problem(seed=s) for s in range(S)]
    arrays = [_stack(problems, k) for k in range(6)]
    fx, fy, cx, cy = problems[0][6:]
    jT0, tT0 = _identities()
    kw = dict(patch=5, max_iters=10, min_rel_decrease=2e-3)
    jT, jrmse, jit = jax.vmap(lambda T, *a: j_lm_align_level(
        T, *a, f32(fx), f32(fy), f32(cx), f32(cy), interpret=True, **kw))(
            jT0, *map(jnp.asarray, arrays))
    tT, trmse, tit = torch.func.vmap(lambda T, *a: lm_align.lm_align_level(
        T, *a, fx, fy, cx, cy, **kw))(tT0, *map(torch.from_numpy, arrays))
    assert tit.shape == (S,) and (np.asarray(jit) >= 2).all()
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_allclose(tT.rotation.numpy(), np.asarray(jT.rotation), atol=1e-4)
    np.testing.assert_allclose(tT.translation.numpy(), np.asarray(jT.translation), atol=1e-4)
    np.testing.assert_allclose(trmse.numpy(), np.asarray(jrmse), rtol=1e-3)
    # two different problems: the batch is not one problem twice
    assert np.abs(np.diff(tT.translation.numpy(), axis=0)).max() > 1e-4


def test_vmapped_fa_align_batch_matches_vmapped_pallas():
    problems = [_fa_problem(seed=s) for s in (1, 2)]
    arrays = [_stack(problems, k) for k in range(7)]
    juv, jerr, jconv = jax.vmap(lambda *a: j_fa_align_batch(*a, patch=5, max_iters=10, interpret=True))(
        *map(jnp.asarray, arrays))
    tuv, terr, tconv = torch.func.vmap(lambda *a: fa_align.fa_align_batch(*a, patch=5, max_iters=10))(
        *map(torch.from_numpy, arrays))
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    assert np.asarray(jconv).sum(1).min() >= 8
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-3)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-3, atol=1e-4)


def test_vmapped_pose_refine_matches_vmapped_pallas():
    problems = [_pose_problem(seed=s) for s in (2, 3)]
    arrays = [_stack(problems, k) for k in range(3)]
    jT0, tT0 = _identities()
    jT, jrmse, jit = jax.vmap(lambda T, *a: j_pose_refine(
        T, *a, max_iters=8, min_rel_decrease=1e-3, interpret=True))(jT0, *map(jnp.asarray, arrays))
    tT, trmse, tit = torch.func.vmap(lambda T, *a: pose_refine.pose_refine(
        T, *a, max_iters=8, min_rel_decrease=1e-3))(tT0, *map(torch.from_numpy, arrays))
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_allclose(tT.rotation.numpy(), np.asarray(jT.rotation), atol=1e-4)
    np.testing.assert_allclose(tT.translation.numpy(), np.asarray(jT.translation), atol=1e-4)
    np.testing.assert_allclose(trmse.numpy(), np.asarray(jrmse), rtol=1e-3)
    for s, p in enumerate(problems):  # each polish moves towards its own true pose
        err = np.linalg.norm(tT.translation[s].numpy() - p[3][:3, 3])
        assert err < 0.2 * np.linalg.norm(p[3][:3, 3]), (s, err)


def test_vmapped_depth_scores_match_vmapped_pallas():
    problems = [_depth_problem(seed=s) for s in (3, 4)]
    win, cref, offs = (_stack(problems, k) for k in range(3))
    R, WH, WW = win.shape[1:]
    jsc, jok = jax.vmap(lambda w, c, o: j_depth_scores(w, c, o, patch=7, win_h=WH, win_w=WW, block=128,
                                                       interpret=True))(
        jnp.asarray(win.reshape(S, R, -1)), jnp.asarray(cref), jnp.asarray(offs))
    tsc, tok = torch.func.vmap(lambda w, c, o: depth_scores.depth_scores(w, c, o, patch=7))(
        *map(torch.from_numpy, (win, cref, offs)))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5, atol=5e-3)
