"""The two LM kernels' functions (K1 ``lm_align_level``, K3 ``pose_refine``)
at the shapes their CUDA thread mappings make interesting, the port's
entry-point device rule, and the kernels' bounds.

On the CPU the port's wrapper takes its plain PyTorch version, which is what
the CUDA kernel is held against on the card (``test_torch_gpu.py``); here it
is held against the Pallas kernel in interpret mode on the same numpy inputs,
made from a seed by ``selfcheck``'s problem constructors. Tolerances as in
``test_torch_kernels.py``: both sides are float32 with different summation
orders, so an LM on the same accept/reject path agrees to ~1e-5 in pose;
1e-4 per pose entry and 1e-3 relative rmse leave room for that and still
catch a changed step or branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.geometry.se3 import SE3 as JSE3
from sdvo_tpu.ops.pallas_lm import lm_align_level as j_lm_align_level
from sdvo_tpu.ops.pallas_pose import pose_refine as j_pose_refine

from sdvo_tpu_torch.config import load_config
from sdvo_tpu_torch.convert import vo_state_from_numpy
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.ops import lm_align, pose_refine, selfcheck
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

torch.set_num_threads(2)
CPU = torch.device("cpu")
J_IDENTITY = JSE3(jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32))


def _same_pose(tT, jT, trmse, jrmse):
    np.testing.assert_allclose(tT.rotation.numpy(), np.asarray(jT.rotation), atol=1e-4)
    np.testing.assert_allclose(tT.translation.numpy(), np.asarray(jT.translation), atol=1e-4)
    np.testing.assert_allclose(float(trmse), float(jrmse), rtol=1e-3, atol=1e-7)


def _initial_pose_kept(T, iterations):
    np.testing.assert_array_equal(np.asarray(T.rotation), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(T.translation), np.zeros(3, np.float32))
    assert int(iterations) in (0, 1)


# N = 37: no multiple of a warp; N = 300: more residuals than the 7 × 1024 a
# block keeps in registers; patch 4; and every feature invisible
@pytest.mark.parametrize("n,patch,blind", [(37, 5, False), (300, 5, False), (64, 4, False),
                                           (37, 5, True)],
                         ids=["N37", "N300", "patch4", "N37-blind"])
def test_lm_align_level_shapes_match_pallas(n, patch, blind):
    args, _ = selfcheck.lm_problems(CPU, n=n, width=640, height=240, patch=patch)[0]
    win, patches, J, pts, org, vis = (a.numpy() for a in args[:6])
    if blind:
        vis = np.zeros_like(vis)
    fx, fy, cx, cy = args[6:]
    kw = dict(patch=patch, max_iters=10, min_rel_decrease=2e-3)
    jT, jrmse, jit = j_lm_align_level(
        J_IDENTITY, *(jnp.asarray(a) for a in (win, patches, J, pts, org, vis)),
        *(jnp.float32(v) for v in (fx, fy, cx, cy)), interpret=True, **kw)
    tT, trmse, tit = lm_align.lm_align_level(
        SE3.identity(), *(torch.from_numpy(a) for a in (win, patches, J, pts, org, vis)),
        fx, fy, cx, cy, **kw)
    if blind:
        _initial_pose_kept(jT, jit)
        _initial_pose_kept(tT, tit)
        return
    assert int(jit) >= 2 and int(tit) == int(jit)
    _same_pose(tT, jT, trmse, jrmse)


# N = 1 and 33: one lane, one lane past a warp; N = 500: beyond the one-warp
# and the one-observation-a-thread forms; and every observation invalid
@pytest.mark.parametrize("n,blind", [(1, False), (33, False), (500, False), (33, True)],
                         ids=["N1", "N33", "N500", "N33-blind"])
def test_pose_refine_shapes_match_pallas(n, blind):
    args, _ = selfcheck.pose_problem(CPU, n=n, outliers=n // 10)
    pts, brg, valid = (a.numpy() for a in args)
    if blind:
        valid = np.zeros_like(valid)
    kw = dict(max_iters=8, min_rel_decrease=1e-3)
    jT, jrmse, jit = j_pose_refine(J_IDENTITY, jnp.asarray(pts), jnp.asarray(brg),
                                   jnp.asarray(valid), interpret=True, **kw)
    tT, trmse, tit = pose_refine.pose_refine(SE3.identity(), torch.from_numpy(pts),
                                             torch.from_numpy(brg), torch.from_numpy(valid), **kw)
    if blind:
        _initial_pose_kept(jT, jit)
        _initial_pose_kept(tT, tit)
        return
    if n > 1:
        assert int(tit) == int(jit)
    else:
        # one observation fits exactly: chi² falls to rounding zero (rmse < 1e-6), where
        # the chi²-decrease test is noise and the two stop at different iterations, at
        # the same pose
        assert float(trmse) < 1e-6 and float(jrmse) < 1e-6
        jrmse = trmse
    _same_pose(tT, jT, trmse, jrmse)


def _device_system(**kw):
    return DeviceSystem(load_config(), **kw)


def _state(**kw):
    class SE3(tuple):  # a NamedTuple stand-in: matched by class and field names
        _fields = ("rotation", "translation")
        rotation = property(lambda self: self[0])
        translation = property(lambda self: self[1])

    return vo_state_from_numpy(SE3((np.eye(3, dtype=np.float32), np.zeros(3, np.float32))), **kw)


@pytest.mark.parametrize("entry", [_device_system, _state], ids=["DeviceSystem", "vo_state_from_numpy"])
def test_entry_point_without_device_raises_without_cuda(entry):
    """The card is the default; where there is none the entry point raises and
    names ``device="cpu"``: it never carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device exists")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry()


@pytest.mark.parametrize("entry", [_device_system, _state], ids=["DeviceSystem", "vo_state_from_numpy"])
def test_entry_point_on_the_cpu_when_asked(entry):
    out = entry(device="cpu")
    device = out.device if isinstance(out, DeviceSystem) else out.rotation.device
    assert device.type == "cpu"


# main-path shapes: bytes in and out, operations, the bound's time and what sets it
@pytest.mark.parametrize("name,shapes,iterations,nbytes,flops,ms,by", [
    ("lm_align_level", dict(N=256, WH=16, WW=32, P2=25), 4, 709_744, 3_224_640, 2.12e-4, "bytes"),
    ("lm_align_level", dict(N=256, WH=16, WW=32, P2=25), 10, 709_744, 7_601_088, 2.12e-4, "bytes"),
    ("fa_align_batch", dict(N=150, WH=24, WW=32, P2=25), None, 510_300, 3_765_000, 1.52e-4, "bytes"),
    ("pose_refine", dict(N=150), 8, 4_312, 520_326, 7.77e-6, "operations"),
    ("depth_scores", dict(N=8192, WH=12, WW=32, P2=49, win_bytes=3_928_064), None, 5_664_768,
     7_225_344, 1.69e-3, "bytes"),
    ("depth_scores", dict(N=8192, WH=12, WW=32, P2=49, win_bytes=3_928_064, steps=16), None, 4_159_488,
     7_225_344, 1.242e-3, "bytes"),
], ids=["K1-4it", "K1-10it", "K2", "K3", "K4", "K4-steps16"])
def test_bound_ms_at_main_path_shapes(name, shapes, iterations, nbytes, flops, ms, by):
    """A pure shape computation: K1 ≈ 0.71 MB → 0.21 µs by bytes at every
    level (its ≈ 7.6 MFLOP at 10 iterations are 0.11 µs); K2 ≈ 0.51 MB →
    0.15 µs (the live mask and the converged flag one byte a feature; its
    ≈ 3.8 MFLOP — eleven evaluations with one robust scale of two ten-step
    bisections each, ten H/g passes — are 0.056 µs); K3 4.3 KB is 1.3 ns of
    bytes but ≈ 0.52 MFLOP, 7.8 ns, of operations; K4 ≈ 5.7 MB → 1.7 µs
    (of its 12.6 MB of windows the 3.9 MB of sectors that the main path's
    footprints touch, ``test_k4_bound_counts_the_sectors_its_footprints_touch``)
    with a reference patch a row, ≈ 4.2 MB → 1.24 µs with one a filter of
    16 steps (``steps``: 512 patches of 49 floats instead of 8192)."""
    bound = selfcheck.bound_ms(name, shapes, iterations)
    assert bound.bytes == nbytes
    assert bound.flops == flops
    assert bound.by == by
    assert bound.ms == pytest.approx(ms, rel=0.01)
    assert bound.ms == max(bound.bytes / 3.35e12, bound.flops / 67e12) * 1e3


def test_k4_bound_counts_the_sectors_its_footprints_touch():
    """K4 reads of each window only the 32-byte sectors of its 8×8 bilinear
    footprint: a corner on a sector's start takes one sector a row, one
    inside a sector two, one past the window nothing, one over its edge only
    the rows and columns inside; the main path's problem (``depth_problem``,
    8192 rows at patch 7 in 12×32 windows) touches 3,928,064 bytes of its
    12,582,912."""
    offs = torch.tensor([[3.5, 3.5],     # corner (0, 0): 8 rows × sector 0
                         [8.25, 4.0],    # corner (5, 1): 8 rows × sectors 0-1
                         [-20.0, 4.0],   # left of the window: nothing
                         [30.0, 10.5]])  # corner (27, 7): rows 7-11, columns 27-31
    assert selfcheck.footprint_bytes(offs, 7, 12, 32) == (8 + 16 + 0 + 5) * 32
    shapes = selfcheck.problem_shapes("depth_scores", tuple(selfcheck.depth_problem(torch.device("cpu"))))
    assert shapes == dict(N=8192, WH=12, WW=32, P2=49, win_bytes=3_928_064)
