"""The port's multi-sequence path (``sdvo_tpu_torch.parallel``, the ``seq``
axis) on the CPU: each kernel op under ``torch.func.vmap``, the batched
alignment step and ``MultiSequenceSystem`` against the port's single-sequence
``DeviceSystem`` and against the JAX package.

Scene: two ridge sequences of ``test_pipeline_e2e.make_sequence`` (seeds 7
and 100, 320×240) with the configuration of ``test_multi_seq._msys`` (96
matches, 256 filters, chunks of two supersteps), which is
``test_torch_device_system``'s. Every system bootstraps with the RANSAC
draws the JAX ``System`` of seed i makes for sequence i, so the port and
the JAX package start from the same two-view solution.

``jax.vmap`` of each Pallas kernel is held against the port's vmapped ops in
``test_torch_vmap_kernels.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.align.image_alignment import AlignFeatures as JAlignFeatures
from sdvo_tpu.align.image_alignment import SparseImageAlign as JSparseImageAlign
from sdvo_tpu.config import load_config as j_load_config
from sdvo_tpu.geometry.camera import PinholeCamera as JCamera
from sdvo_tpu.geometry.se3 import SE3 as JSE3
from sdvo_tpu.parallel.batched_vo import batched_align_step as j_batched_align_step
from sdvo_tpu.parallel.mesh import make_vo_mesh as j_make_vo_mesh
from sdvo_tpu.parallel.multi_seq import MultiSequenceSystem as JMultiSequenceSystem

from sdvo_tpu_torch.align.image_alignment import AlignFeatures, SparseImageAlign
from sdvo_tpu_torch.config import load_config
from sdvo_tpu_torch.convert import to_numpy, vo_state_from_numpy
from sdvo_tpu_torch.dataio.evaluate import ate_rmse
from sdvo_tpu_torch.device import deterministic_algorithms
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.pyramid import build_pyramid
from sdvo_tpu_torch.ops import depth_scores, fa_align, lm_align, pose_refine
from sdvo_tpu_torch.parallel import (MultiSequenceSystem, batched_align_step, make_vo_mesh,
                                     stack_states, unstack_states, vmap_fallbacks)
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem
from sdvo_tpu_torch.pipeline.system import System

from test_pipeline_e2e import CAM, make_sequence
from test_torch_device_system import KW, OVERRIDES
from test_torch_kernels import _depth_problem, _fa_problem, _lm_problem, _pose_problem
from test_torch_modules import _plane_images

torch.set_num_threads(2)

N_SEQ = 2
N_FRAMES = 17  # bootstrap 2, two joint chunks of 6, a tail superstep of 3
JAX_FRAMES = 8  # the JAX run: bootstrap and one joint chunk
BLACK = range(5, 8)  # sequence 1's second superstep of the first joint chunk
KERNEL_MODULES = (lm_align, fa_align, pose_refine, depth_scores)


def _centers(traj):
    return np.asarray([-T[:3, :3].T @ T[:3, 3] for T in traj])


def _results(metrics):
    return [m["result"] for m in metrics]


def _counters():
    return [(m.launches, m.plain_cuda_calls) for m in KERNEL_MODULES]


# ---------------------------------------------------------------- the ops
def _op_case(kernel):
    """(the wrapper as a function of tensors only, three problems as lists
    of numpy arrays)."""
    rng = np.random.default_rng(11)

    def start():  # a perturbed initial pose per problem: rotation, translation
        return [np.eye(3, dtype=np.float32), rng.normal(0, 0.01, 3).astype(np.float32)]

    if kernel == "lm_align_level":
        problems = [_lm_problem(seed=s) for s in range(3)]
        fx, fy, cx, cy = problems[0][6:]
        return (lambda R, t, *a: lm_align.lm_align_level(SE3(R, t), *a, fx, fy, cx, cy, patch=5,
                                                         max_iters=10, min_rel_decrease=2e-3),
                [start() + list(p[:6]) for p in problems])
    if kernel == "fa_align_batch":
        return (lambda *a: fa_align.fa_align_batch(*a, patch=5, max_iters=10),
                [list(_fa_problem(seed=s)) for s in (1, 2, 3)])
    if kernel == "pose_refine":
        return (lambda R, t, *a: pose_refine.pose_refine(SE3(R, t), *a, max_iters=8,
                                                         min_rel_decrease=1e-3),
                [start() + list(_pose_problem(seed=s)[:3]) for s in (2, 3, 4)])
    return (lambda *a: depth_scores.depth_scores(*a, patch=7),
            [list(_depth_problem(seed=s)) for s in (3, 4, 5)])


def _leaves(out):
    return [y for x in out for y in (x if isinstance(x, SE3) else (x,))]


@pytest.mark.parametrize("kernel", ["lm_align_level", "fa_align_batch", "pose_refine", "depth_scores"])
def test_vmapped_op_equals_per_problem_calls(kernel):
    """S = 3 stacked problems through ``torch.func.vmap`` of the wrapper (the
    custom op's vmap rule) equal the three calls one by one exactly, and
    nothing is launched on CPU tensors."""
    fn, problems = _op_case(kernel)
    stacked = [torch.from_numpy(np.stack([p[k] for p in problems])) for k in range(len(problems[0]))]
    before = _counters()
    got = _leaves(torch.func.vmap(fn)(*stacked))
    for s, p in enumerate(problems):
        want = _leaves(fn(*[torch.from_numpy(np.asarray(a)) for a in p]))
        for g, w in zip(got, want):
            assert g.shape[1:] == w.shape and g.dtype == w.dtype
            assert torch.equal(g[s], w), (kernel, s)
    assert _counters() == before


# --------------------------------------------------------- the alignment step
CURRENT = ([0.06, -0.03, 0.04, 0.002, -0.003, 0.004], [0.04, -0.03, 0.05, 0.001, -0.002, 0.003])


def _align_problem(levels):
    """S = 2 planes (texture seeds 21, 22) at z = 10, each seen from the
    world origin, a keyframe 0.15 to the side and a current frame; 16
    features hosted by each of the first two, every point in the reference
    frame (``test_torch_system._two_host_problem``, one scene a sequence)."""
    fx, fy, cx, cy = (CAM[k] for k in ("fx", "fy", "cx", "cy"))
    hosts, curs, feats, truth = [], [], [], []
    for s in range(N_SEQ):
        (ref, kf, cur), Ts = _plane_images(21 + s, [np.zeros(6), [-0.15, 0.02, 0.0, 0.0, 0.004, 0.0],
                                                   CURRENT[s]])
        pyrs = [build_pyramid(torch.from_numpy(x), levels) for x in (ref, kf, cur)]
        hosts.append([np.stack([pyrs[0].images[lv].numpy(), pyrs[1].images[lv].numpy()])
                      for lv in range(levels)])
        curs.append([pyrs[2].images[lv].numpy() for lv in range(levels)])
        uu, vv = np.meshgrid(np.linspace(50, 270, 4), np.linspace(50, 190, 4))
        uv = np.stack([uu.ravel(), vv.ravel()], -1)
        n = len(uv)
        uv_host = np.concatenate([uv, uv + 0.3]).astype(np.float32)
        b = np.stack([(uv_host[:, 0] - cx) / fx, (uv_host[:, 1] - cy) / fy, np.ones(2 * n)], -1)
        R, t = Ts[1][:3, :3], Ts[1][:3, 3]
        ray = b[n:] @ R
        origin = -R.T @ t
        pts = np.concatenate([b[:n] * 10.0, origin + ((10.0 - origin[2]) / ray[:, 2])[:, None] * ray])
        feats.append((uv_host, np.repeat(np.arange(2, dtype=np.int32), n), pts.astype(np.float32),
                      np.arange(2 * n) != 2 * n - 1))
        truth.append(Ts[2])
    host = [np.stack([h[lv] for h in hosts]) for lv in range(levels)]
    cur = [np.stack([c[lv] for c in curs]) for lv in range(levels)]
    feats = [np.stack([f[k] for f in feats]) for k in range(4)]
    return host, cur, feats, truth


def test_batched_align_step_matches_jax():
    """S = 2 through the port's ``batched_align_step`` on a mesh of two CPU
    devices against the JAX step with ``backend="pallas"`` (K1 in interpret
    mode) on a mesh of two CPU devices, both over two levels. Compared where
    the alignment measures a pose, by where it puts the features: within
    0.01 px of each other, as the one-sequence test of ``SparseImageAlign``
    in ``test_torch_system`` holds them; rmse 1 %."""
    levels = 2
    host, cur, feats, truth = _align_problem(levels)
    fx, fy, cx, cy = (CAM[k] for k in ("fx", "fy", "cx", "cy"))
    f32 = jnp.float32
    j_mesh = j_make_vo_mesh(num_seq=2, num_shard=1, devices=jax.devices()[:2])
    j_step = j_batched_align_step(JSparseImageAlign(patch_size=5, min_level=0, max_level=levels - 1,
                                                    backend="pallas"), j_mesh, levels)
    jT0 = JSE3(jnp.broadcast_to(jnp.eye(3, dtype=f32), (N_SEQ, 3, 3)), jnp.zeros((N_SEQ, 3), f32))
    jT, jrmse, _ = j_step(j_step.place(jT0), j_step.place(tuple(map(jnp.asarray, host))),
                          j_step.place(tuple(map(jnp.asarray, cur))),
                          j_step.place(JAlignFeatures(*map(jnp.asarray, feats))),
                          f32(fx), f32(fy), f32(cx), f32(cy))

    mesh = make_vo_mesh(devices=["cpu"] * 2)
    assert mesh.axis_names == ("seq", "shard") and mesh.devices.shape == (2, 1)
    step = batched_align_step(SparseImageAlign(patch_size=5, min_level=0, max_level=levels - 1),
                              mesh, levels)
    before = _counters()
    tT, trmse, status = step(step.place(SE3.identity((N_SEQ,))),
                             step.place(tuple(map(torch.from_numpy, host))),
                             step.place(tuple(map(torch.from_numpy, cur))),
                             step.place(AlignFeatures(*map(torch.from_numpy, feats))), fx, fy, cx, cy)
    assert _counters() == before
    assert tT.translation.shape == (N_SEQ, 3) and trmse.shape == status.shape == (N_SEQ,)
    pts = feats[2].astype(np.float64)
    for s in range(N_SEQ):
        def project(R, t):
            p = pts[s] @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
            return np.stack([fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy], -1)

        apart = np.abs(project(tT.rotation[s].numpy(), tT.translation[s].numpy())
                       - project(jT.rotation[s], jT.translation[s])).max()
        assert apart < 0.01, (s, apart)
        np.testing.assert_allclose(float(trmse[s]), float(jrmse[s]), rtol=1e-2)
        # and each finds its own motion: features within 0.05 px of where the
        # true pose puts them (measured 0.019 and 0.016)
        off = np.abs(project(tT.rotation[s].numpy(), tT.translation[s].numpy())
                     - project(truth[s][:3, :3], truth[s][:3, 3])).max()
        assert off < 0.05, (s, off)


# --------------------------------------------------------- the whole system
SCENES = (7, 100)  # make_sequence seeds


def _sequences():
    seqs, gts = [], []
    for seed in SCENES:
        _, images, poses = make_sequence(np.random.default_rng(seed), n_frames=N_FRAMES)
        seqs.append([np.asarray(im, np.float64) for im in images])
        gts.append(poses)
    return seqs, gts


def _jax_uniforms(seqs):
    """The RANSAC draws of the first bootstrap attempt of the JAX ``System``
    of seed i, for sequence i (its frame-0 features are the port's)."""
    out = []
    for i, seq in enumerate(seqs):
        host = System(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM), device="cpu")
        host.add_image(seq[0], 0.0)
        _, sub = jax.random.split(jax.random.PRNGKey(i))
        out.append(np.asarray(jax.random.uniform(sub, (256, len(host.ref_frame.feat_uv)),
                                                 dtype=jnp.float64)))
    return out


def _multi(uniforms, mesh=None):
    return MultiSequenceSystem(load_config(overrides=OVERRIDES), N_SEQ, camera=PinholeCamera.create(**CAM),
                               mesh=mesh, device=None if mesh else "cpu", ransac_uniforms=uniforms, **KW)


@pytest.fixture(scope="module")
def runs():
    """The two sequences through ``MultiSequenceSystem`` (recording vmap's
    fallbacks) and through a ``DeviceSystem`` each."""
    seqs, gts = _sequences()
    uniforms = _jax_uniforms(seqs)
    ms = _multi(uniforms)
    before = _counters()
    with vmap_fallbacks() as fallbacks:
        multi = ms.run(seqs)
    counters = _counters() == before
    single = []
    for i, seq in enumerate(seqs):
        ds = DeviceSystem(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM), seed=i,
                          device="cpu", ransac_uniforms=uniforms[i], **KW)
        for j, im in enumerate(seq):
            ds.add_image(im, float(j))
        ds.finish()
        single.append(ds)
    return dict(seqs=seqs, gts=gts, uniforms=uniforms, ms=ms, multi=multi, single=single,
                fallbacks=fallbacks, counters=counters)


def test_multi_seq_runs_on_the_path_without_fallbacks(runs):
    """Every frame of both sequences tracked, through the joint chunks and
    the tail; no op of the vmapped superstep fell back to a loop over the
    batch, and nothing was launched on CPU tensors."""
    assert runs["fallbacks"] == set()
    assert runs["counters"]
    for res, gt in zip(runs["multi"], runs["gts"]):
        assert len(res["trajectory"]) == len(res["metrics"]) == N_FRAMES
        assert all(T is not None for T in res["trajectory"])
        assert _results(res["metrics"]) == ["KEYFRAME", "KEYFRAME"] + ["SUCCESS", "SUCCESS", "KEYFRAME"] * 5


# vmap batches every op of the superstep, so sums and small matrix products
# take other orders than in one sequence's calls: the first outputs that
# differ are ``se3``'s 3×3 products, which vmap turns into batched matmuls
# (they differ at a batch of one too), while a Python loop over the
# sequences in place of vmap gives each its DeviceSystem run bit for bit, so
# nothing but rounding separates the two paths. Up to the first joint
# keyframe the runs agree to 5e-8 of the path; from the keyframe step on, the
# float32 windowed BA (a gauge freedom) lifts that to 5e-4 within two
# frames, and the LMs'
# accept tests keep it growing: 3.7 % and 7.5 % of the path by frame 16 (with
# the RANSAC draws of another seed, 5.6 % and 11 %). A centre band over the
# whole run would hold nothing. So each sequence is held as the JAX package
# holds its own vmapped run against its DeviceSystem
# (``test_multi_seq.py::test_multi_seq_matches_single_seq``): translations
# within 5e-3 over the first 10 frames (measured 1.1e-3 and 1.7e-4; 1.7e-4 and
# 5.1e-4 with the other draws), the same result for every frame, and both
# runs on the ground truth over all of them.
SINGLE_FRAMES = 10
SINGLE_ATOL = 5e-3


def test_multi_seq_matches_device_system_alone(runs):
    """Each sequence of the joint run against the port's ``DeviceSystem`` run
    alone on it: the same bootstrap bit for bit, the same result for every
    frame, translations within ``SINGLE_ATOL`` over the first
    ``SINGLE_FRAMES`` frames, and both on the ground truth (scale-aligned
    ATE < 0.05)."""
    for i, (res, ds, gt) in enumerate(zip(runs["multi"], runs["single"], runs["gts"])):
        assert _results(res["metrics"]) == _results(ds.metrics), i
        cm, cs = _centers(res["trajectory"]), _centers(ds.trajectory)
        np.testing.assert_array_equal(cm[:2], cs[:2])  # the host bootstrap
        tm = np.asarray([T[:3, 3] for T in res["trajectory"][:SINGLE_FRAMES]])
        ts = np.asarray([T[:3, 3] for T in ds.trajectory[:SINGLE_FRAMES]])
        np.testing.assert_allclose(tm, ts, rtol=0, atol=SINGLE_ATOL, err_msg=str(i))
        for c in (cm, cs):
            assert ate_rmse(c, _centers(gt), with_scale=True) < 0.05, i


def test_a_sequence_gets_the_same_bits_in_either_slot(runs):
    """The two sequences swapped, each keeping its RANSAC draws (the first
    bootstrap attempt takes them, so the seed of the slot plays no part):
    each gets the bits of its run in the other slot, frame for frame: no op
    of the vmapped superstep rounds a member by its slot. (On the CPU this
    held with matmuls in ``se3`` too; on the card batched cuBLAS products
    did round by slot, which ``test_torch_gpu`` checks.)"""
    ms = MultiSequenceSystem(load_config(overrides=OVERRIDES), N_SEQ, camera=PinholeCamera.create(**CAM),
                             device="cpu", ransac_uniforms=runs["uniforms"][::-1], **KW)
    swapped = ms.run(runs["seqs"][::-1])
    for i in range(N_SEQ):
        np.testing.assert_array_equal(np.asarray(swapped[N_SEQ - 1 - i]["trajectory"]),
                                      np.asarray(runs["multi"][i]["trajectory"]), err_msg=str(i))


def test_multi_seq_matches_jax_multi_seq(runs):
    """The JAX ``MultiSequenceSystem`` (its CPU default, XLA) over the first
    ``JAX_FRAMES`` frames of both sequences — the bootstrap and one joint
    chunk — against the port's joint run: the same result per frame, camera
    centres within 2 % of the path, the band of
    ``test_torch_device_system`` (binned vs histogram MAD, the per-feature
    freeze of feature alignment and the iteration taper differ between the
    XLA path and the kernels' semantics; measured 0.49 % and 0.80 %)."""
    jms = JMultiSequenceSystem(j_load_config(overrides=OVERRIDES), N_SEQ,
                               camera=JCamera.create(**CAM, dtype=jnp.float64), **KW)
    jres = jms.run([list(s[:JAX_FRAMES]) for s in runs["seqs"]])
    for i, (j, t) in enumerate(zip(jres, runs["multi"])):
        assert _results(t["metrics"][:JAX_FRAMES]) == _results(j["metrics"]), i
        cj, ct = _centers(j["trajectory"]), _centers(t["trajectory"][:JAX_FRAMES])
        path = float(np.sum(np.linalg.norm(np.diff(cj, axis=0), axis=-1)))
        err = np.linalg.norm(ct - cj, axis=-1).max()
        assert err < 0.02 * path, (i, err, path)


def test_failed_sequence_is_isolated_and_relocalizes(runs):
    """Sequence 1 black for one superstep: it fails from there to the end of
    the joint phase (its state frozen by ``VOState.failed``), relocalizes on
    the host in the tail and tracks again, while sequence 0's trajectory is
    exactly that of the run without the blackout."""
    seqs = [list(runs["seqs"][0]), [np.zeros_like(im) if j in BLACK else im
                                   for j, im in enumerate(runs["seqs"][1])]]
    ms = _multi(runs["uniforms"])
    res = ms.run(seqs)
    for T, T_clean in zip(res[0]["trajectory"], runs["multi"][0]["trajectory"]):
        np.testing.assert_array_equal(T, T_clean)
    assert _results(res[0]["metrics"]) == _results(runs["multi"][0]["metrics"])
    joint_end = 2 + 2 * 2 * 3
    r1 = _results(res[1]["metrics"])
    assert r1[:BLACK[0]] == _results(runs["multi"][1]["metrics"])[:BLACK[0]]
    assert set(r1[BLACK[0]:joint_end]) == {"FAILED"}, r1
    assert all(T is None for T in res[1]["trajectory"][BLACK[0]:joint_end])
    assert ms.subs[1].n_relocalizations == 1 and ms.subs[0].n_relocalizations == 0
    assert "FAILED" not in r1[joint_end:], r1


def test_the_tracer_records_each_joint_chunk_and_changes_no_bit(runs):
    """The bootstrap and the first joint chunk of both sequences again with
    the tracer on: the fixture's frames bit for bit; the chunk a
    ``multi_seq.chunk`` span (one dispatch) holding ``stack``, ``copy_in``
    and ``emit`` once each; every bootstrap frame a
    ``device_system.bootstrap`` span; the counters the sums of the emitted
    ``FrameOut`` fields of both sequences under the vmap, K1's iterations
    within each level's budget; ``multi_seq.staged_frames`` the frames of
    both sequences, ``multi_seq.staged_bytes`` 4·H·W a frame (the float64
    frames are staged as float32)."""
    from sdvo_tpu_torch.utils.timing import TRACER

    from test_torch_device_system import _spied

    seqs = [s[:JAX_FRAMES] for s in runs["seqs"]]
    ms = _multi(runs["uniforms"])
    emitted = []
    for sub in ms.subs:
        _spied(sub, emitted)
    with TRACER.recording() as tr:
        ms.bootstrap(seqs)
        ms.joint(seqs)
    for i, sub in enumerate(ms.subs):
        np.testing.assert_array_equal(np.asarray(sub.trajectory),
                                      np.asarray(runs["multi"][i]["trajectory"][:JAX_FRAMES]), err_msg=str(i))
    spans = tr.spans
    (c,) = [k for k, s in enumerate(spans) if s.name == "multi_seq.chunk"]
    assert tr.dispatches == 1 and spans[c].parent == -1 and spans[c].dispatch == 0
    assert [s.name for s in spans if s.parent == c and s.name.startswith("multi_seq.")] == [
        "multi_seq.stack", "multi_seq.copy_in", "multi_seq.emit"]
    assert sum(s.name == "device_system.bootstrap" for s in spans) == 2 * N_SEQ
    assert len(emitted) == N_SEQ and all(n == JAX_FRAMES - 2 for _, n in emitted)
    its = np.concatenate([o.align_iters.reshape(n, -1) for o, n in emitted])
    assert (its >= 0).all() and (its <= [4, 6, 8, 10]).all(), its
    assert tr.counter("lm_align_level.iterations") == its.sum()
    assert tr.counter("lm_align_level.launches") == its.size == 4 * N_SEQ * (JAX_FRAMES - 2)
    assert tr.counter("pose_refine.iterations") == sum(o.refine_iters.sum() for o, _ in emitted)
    assert tr.counter("device_vo.keyframe_steps") == 2 * N_SEQ
    assert tr.counter("device_vo.ba_solves") == sum(o.ba_solved.sum() for o, _ in emitted)
    H, W = seqs[0][0].shape
    assert tr.counter("multi_seq.staged_frames") == N_SEQ * (JAX_FRAMES - 2)
    assert tr.counter("multi_seq.staged_bytes") == 4 * H * W * tr.counter("multi_seq.staged_frames")


def _images_as_stacked(seqs, starts, C, per):
    """A joint chunk's images as the joint phase made them before it staged
    frames through one buffer: each sequence's frames stacked and converted
    by ``astype(np.float32)``, the sequences stacked, laid out (C, S, per,
    H, W) by a transpose."""
    imgs = np.stack([np.stack(s[a:a + C * per]).astype(np.float32) for s, a in zip(seqs, starts)])
    return np.ascontiguousarray(imgs.reshape(len(seqs), C, per, *imgs.shape[2:]).transpose(1, 0, 2, 3, 4))


@pytest.mark.parametrize("dtype", ["uint8", "float64"])
def test_joint_hands_each_chunk_the_images_it_had_before(runs, dtype):
    """Both sequences as 8-bit frames (staged as uint8) and as the fixture's
    float64 frames (staged as float32): each joint chunk is given,
    bit for bit, the float32 images the joint phase made before from the
    same frames, out of one host buffer for both chunks; the tracer's
    counters read ``element_size``·H·W bytes a staged frame; and the run
    gives the fixture's trajectories bit for bit (the scene's frames are
    whole grey levels, so both are the fixture's frames)."""
    from sdvo_tpu_torch.utils.timing import TRACER

    seqs = [[f.astype(dtype) for f in s] for s in runs["seqs"]]
    ms = _multi(runs["uniforms"])
    ms.bootstrap(seqs)
    starts = list(ms._ptr)
    chunk_fn, given, hosts = ms.chunk_fn, [], []

    def spy(state, images):
        given.append(images.clone())
        hosts.append(ms._staging.host.data_ptr())
        return chunk_fn(state, images)

    ms.chunk_fn = spy
    with TRACER.recording() as tr:
        ms.joint(seqs)
    C, per = ms.supersteps_per_chunk, ms.period
    assert len(given) == 2 and hosts[0] == hosts[1]
    host = ms._staging.host
    assert host.dtype == (torch.uint8 if dtype == "uint8" else torch.float32)
    for k, images in enumerate(given):
        assert images.dtype == torch.float32
        np.testing.assert_array_equal(images.numpy(), _images_as_stacked(seqs, [a + k * C * per for a in starts],
                                                                          C, per), err_msg=str(k))
    H, W = seqs[0][0].shape
    assert tr.counter("multi_seq.staged_frames") == 2 * N_SEQ * C * per
    assert tr.counter("multi_seq.staged_bytes") == host.element_size() * H * W * tr.counter("multi_seq.staged_frames")
    for i, res in enumerate(ms.tail(seqs)):
        np.testing.assert_array_equal(np.asarray(res["trajectory"]), np.asarray(runs["multi"][i]["trajectory"]),
                                      err_msg=str(i))


class _Stop(Exception):
    pass


def test_the_staging_buffer_is_kept_until_the_frames_shape_or_type_changes(runs):
    """The joint phase's host buffer is allocated at its first chunk and
    kept from one call to the next; frames of another type (8-bit after
    float64, float64 and 8-bit mixed) or of another size get a new one. Each
    call stops at the chunk function, which records the images it is given:
    float32, the frames' values in every case."""
    ms = _multi(runs["uniforms"])
    ms.bootstrap(runs["seqs"])
    starts = list(ms._ptr)
    C, per = ms.supersteps_per_chunk, ms.period
    given = []

    def stop(state, images):
        given.append(images.clone())
        raise _Stop

    ms.chunk_fn = stop
    f64 = runs["seqs"]
    u8 = [[f.astype(np.uint8) for f in s] for s in f64]
    mixed = [u8[0], f64[1]]
    small = [[f[:200, :280] for f in s] for s in u8]
    kept = []
    for seqs in (f64, f64, u8, u8, mixed, mixed, small, small):
        with pytest.raises(_Stop):
            ms.joint(seqs)
        kept.append(ms._staging.host)  # held, so a new buffer cannot take a freed one's memory
        assert given[-1].dtype == torch.float32
        np.testing.assert_array_equal(given[-1].numpy(), _images_as_stacked(seqs, starts, C, per))
    assert [b.dtype for b in kept[::2]] == [torch.float32, torch.uint8, torch.float32, torch.uint8]
    assert kept[7].shape == (C, N_SEQ, per, 200, 280)
    ptrs = [b.data_ptr() for b in kept]
    assert ptrs[0::2] == ptrs[1::2] and len(set(ptrs)) == 4, ptrs


def test_mesh_of_two_cpu_devices_matches_no_mesh(runs):
    """With a mesh of two CPU devices each sequence is a group of its own (a
    batch of one on its device): the same results and the same camera
    centres, bit for bit, as the joint batch of two."""
    mesh = make_vo_mesh(devices=["cpu"] * 2)
    ms = _multi(runs["uniforms"], mesh=mesh)
    assert [(str(d), list(m)) for d, m in ms.groups] == [("cpu", [0]), ("cpu", [1])]
    res = ms.run(runs["seqs"])
    for a, b in zip(res, runs["multi"]):
        assert _results(a["metrics"]) == _results(b["metrics"])
        np.testing.assert_array_equal(_centers(a["trajectory"]), _centers(b["trajectory"]))


def test_stacked_states_round_trip(runs):
    """``stack_states``/``unstack_states`` and ``to_numpy`` /
    ``vo_state_from_numpy`` on a stacked ``VOState`` keep every field and
    dtype."""
    states = [sub.state for sub in runs["ms"].subs]
    stacked = stack_states(states)
    assert stacked.frame_id.shape == (N_SEQ,) and stacked.map.pt_pos.shape[0] == N_SEQ
    back = vo_state_from_numpy(to_numpy(stacked), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(back)), jax.tree_util.tree_leaves(to_numpy(stacked))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for s, one in enumerate(unstack_states(back, N_SEQ)):
        for a, b in zip(jax.tree_util.tree_leaves(to_numpy(one)), jax.tree_util.tree_leaves(to_numpy(states[s]))):
            np.testing.assert_array_equal(a, b)


def test_mesh_and_system_want_the_card_by_default(monkeypatch):
    """Without a card, ``make_vo_mesh()`` and ``MultiSequenceSystem`` without
    a device raise; given CPU devices they build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_vo_mesh()
    with pytest.raises(RuntimeError):
        MultiSequenceSystem(load_config(overrides=OVERRIDES), N_SEQ, camera=PinholeCamera.create(**CAM), **KW)
    mesh = make_vo_mesh(num_seq=2, num_shard=2, devices=["cpu"] * 4)
    assert mesh.devices.shape == (2, 2) and mesh.seq_devices == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        make_vo_mesh(num_seq=3, devices=["cpu"] * 4)


def test_deterministic_algorithms_is_scoped():
    """``deterministic_algorithms`` turns PyTorch's deterministic mode on
    (warning, not raising, where an op has no such form, and leaving
    ``torch.empty`` unfilled) for the block only, and ``vmap_fallbacks``
    inside it records nothing for a batched ``index_add`` and passes other
    warnings on."""
    was = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    with deterministic_algorithms():
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
        assert not torch.utils.deterministic.fill_uninitialized_memory
        with pytest.warns(UserWarning, match="passed on"):
            with vmap_fallbacks() as fallbacks:
                out = torch.func.vmap(lambda x, i: torch.zeros(3).index_add(0, i, x))(
                    torch.ones(2, 4), torch.tensor([[0, 1, 1, 2], [2, 2, 2, 0]]))
                warnings.warn("passed on")
        assert fallbacks == set()
    assert torch.equal(out, torch.tensor([[1.0, 2.0, 1.0], [1.0, 0.0, 3.0]]))
    assert torch.are_deterministic_algorithms_enabled() == was
    assert torch.utils.deterministic.fill_uninitialized_memory == fill
