"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card (marker ``gpu``; every test skips without one).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
The problems are ``sdvo_tpu_torch.ops.selfcheck``'s, at small sizes; the
tolerances are ``selfcheck.agrees``'s.
"""

import functools

import pytest
import torch

from sdvo_tpu_torch.ops import depth_scores, fa_align, lm_align, pose_refine, selfcheck

SMALL = {"lm": 64, "fa": 32, "pose": 40, "depth_filters": 64}
# the host-* cases are K1 at the host path's shape: 512 features (more residuals
# than a block keeps in registers), 12 iterations a level
CASES = ["lm_align_level[L0]", "lm_align_level[L1]", "lm_align_level[L2]", "lm_align_level[L3]",
         "lm_align_level[host-L0]", "lm_align_level[host-L1]", "lm_align_level[host-L2]",
         "lm_align_level[host-L3]", "fa_align_batch", "pose_refine", "depth_scores"]


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(case):
    dev = _cuda()
    cases = {name: (kernel, plain) for name, kernel, plain in selfcheck.kernel_cases(dev, SMALL)}
    kernel, plain = cases[case]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, ok = selfcheck.agrees(case, got, want)
    assert ok, (case, err)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lm_align_level[L3]", "fa_align_batch", "pose_refine", "depth_scores"])
def test_launch_holds_every_tensor_it_writes(case):
    """A launch keeps alive every tensor whose pointer it holds, its outputs
    included: ``selfcheck.cold_launches`` keeps launches without their
    outputs, which must not write into memory the allocator hands on (other
    copies' inputs, which then change the work a launch does)."""
    dev = _cuda()
    name, args, kw = next(p for p in selfcheck.kernel_problems(dev, SMALL) if p[0] == case)
    launch, outs = selfcheck.kernel_launcher(name, args, kw)
    held = {t.data_ptr() for t in launch.tensors}
    assert outs and all(o.data_ptr() in held for o in outs), case


# K1, K2 and K3 at the sizes their thread mappings make interesting
# (``selfcheck.extra_problems``), the all-invisible and all-dead cases included
EXTRA = ["lm_align_level[N37]", "lm_align_level[N300]", "lm_align_level[patch4]",
         "lm_align_level[N37-blind]", "pose_refine[N1]", "pose_refine[N33]", "pose_refine[N500]",
         "pose_refine[N1500]", "pose_refine[N33-blind]", "fa_align_batch[N1]", "fa_align_batch[N37]",
         "fa_align_batch[patch4]", "fa_align_batch[N1500]", "fa_align_batch[dead]",
         "fa_align_batch[edge]"]


@functools.lru_cache(maxsize=None)
def _extra_problems():
    """Built once a process: each renders its own scene."""
    return {p[0]: p for p in selfcheck.extra_problems(torch.device("cuda"))}


# K4 at the shapes its thread mapping makes interesting
# (``selfcheck.depth_extra_problems``) and at the main path's and the
# multi-sequence path's full shapes
DEPTH = ["depth_scores[F1]", "depth_scores[F37]", "depth_scores[patch5]", "depth_scores[edge]",
         "depth_scores[steps1]", "depth_scores", "depth_scores[S8]"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DEPTH)
def test_depth_kernel_matches_plain_at_every_shape(case):
    """Synchronised after the kernel; scores within ``selfcheck.agrees``'s
    5e-2 and ``ok`` equal. At the edge shape every third row's footprint is
    wholly outside its window: its taps read 0, so its score is the sum of
    |cref| and its ``ok`` is false."""
    dev = _cuda()
    if case == "depth_scores[S8]":
        name, stacked, kw, problems = next(p for p in selfcheck.batched_problems(
            dev, 8, dict(SMALL, lm=8, depth_filters=512)) if p[0] == case)
        got = selfcheck.batched_call(name, stacked, kw)()
        want = [selfcheck.case_calls(case, p, kw)[1]() for p in problems]
        want = tuple(torch.stack([w[k] for w in want]) for k in range(2))
    else:
        problems = selfcheck.depth_extra_problems(dev) + [
            p for p in selfcheck.kernel_problems(dev, dict(SMALL, depth_filters=512)) if p[0] == case]
        name, args, kw = next(p for p in problems if p[0] == case)
        kernel, plain = selfcheck.case_calls(name, args, kw)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
    torch.cuda.synchronize()
    err, ok = selfcheck.agrees(case, got, want)
    assert ok, (case, err)
    if case == "depth_scores[edge]":
        cref = torch.repeat_interleave(args[1], kw["steps"], dim=0)
        outside = torch.arange(len(got[0]), device=dev) % 3 == 1
        assert not got[1][outside].any()
        torch.testing.assert_close(got[0][outside], cref[outside].abs().sum(1), rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", EXTRA)
def test_lm_kernel_matches_plain_at_extra_shapes(case):
    """Synchronised after the kernel, so that a hang or a fault shows here."""
    dev = _cuda()
    problem = _extra_problems()[case]
    kernel, plain = selfcheck.case_calls(*problem)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    err, ok = selfcheck.agrees(case, got, want)
    assert ok, (case, err)
    if case.endswith("-blind"):  # nothing visible: the initial pose comes back untouched
        assert err == 0.0
        assert torch.equal(got[0].rotation, torch.eye(3, device=dev))
    if case == "fa_align_batch[dead]":  # no live feature: uv_init comes back, none converged
        assert err == 0.0
        assert torch.equal(got[0], problem[1][4]) and not got[2].any()


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take():
    """A CUDA tensor goes to the kernel or raises: a float64 window table is
    refused before any launch."""
    dev = _cuda()
    args = selfcheck.fa_problem(dev, n=8)
    before = fa_align.launches
    with pytest.raises(TypeError):
        fa_align.fa_align_batch(args[0].double(), *args[1:])
    assert fa_align.launches == before


@pytest.mark.gpu
def test_fa_wrapper_launches_its_kernel_and_nothing_else():
    """At float32 inputs and a bool mask the K2 wrapper enqueues one kernel,
    its own: the profiler sees no other device activity."""
    dev = _cuda()
    args = selfcheck.fa_problem(dev, n=32)
    fa_align.fa_align_batch(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        uv, rmse, conv = fa_align.fa_align_batch(*args)
        torch.cuda.synchronize()
    on_device = [e.key for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.key != "Activity Buffer Request"]
    assert len(on_device) == 1 and "fa_align_kernel" in on_device[0], on_device
    assert uv.dtype == torch.float32 and conv.dtype == torch.bool


@pytest.mark.gpu
def test_host_system_in_float64_on_the_card():
    """The per-frame ``System`` with ``compute_dtype="float64"`` on the card:
    ``local_ba`` and ``optimize_pose`` compute in float64 there, the kernels
    keep their float32 function (their callers cast at the boundary), and
    eight frames of the KITTI-sized ridge scene track."""
    import numpy as np

    from sdvo_tpu_torch.config import load_config
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequence
    from sdvo_tpu_torch.ops import lm_align
    from sdvo_tpu_torch.pipeline.system import System

    _cuda()
    frames, _ = render_bench_sequence(np.random.default_rng(0), 8)
    config = load_config(overrides={
        "initialization": {"disparity_threshold": 3, "threshold_gradient_magnitude": 20},
    }).replace(compute_dtype="float64")
    system = System(config)
    assert system.device.type == "cuda" and system.dtype == torch.float64
    before = (lm_align.launches, lm_align.plain_cuda_calls)
    results = [system.add_image(f.astype(np.float32), float(i)).name for i, f in enumerate(frames)]
    assert results == ["KEYFRAME", "KEYFRAME", "SUCCESS", "SUCCESS", "KEYFRAME", "SUCCESS", "SUCCESS",
                       "KEYFRAME"], results
    assert system.filters.mu.dtype == torch.float64 and system.n_local_ba >= 1
    assert lm_align.launches - before[0] == 4 * 6 and lm_align.plain_cuda_calls == before[1]


# each kernel's one launch for S = 8 stacked problems (``torch.func.vmap`` of
# its wrapper, as the multi-sequence path calls it), problem by problem
MODULES = {"lm_align_level": lm_align, "fa_align_batch": fa_align, "pose_refine": pose_refine,
           "depth_scores": depth_scores}
BATCHED = ["lm_align_level[S8-L0]", "lm_align_level[S8-L1]", "lm_align_level[S8-L2]",
           "lm_align_level[S8-L3]", "fa_align_batch[S8]", "pose_refine[S8]", "depth_scores[S8]"]


@functools.lru_cache(maxsize=None)
def _batched_problems():
    """K1 at the main path's 256 features: at 64, two of the eight textures
    (seeds 2 and 5) put the plain version and the kernel, launched alone, on
    different LM paths (a stall test at its edge)."""
    return {p[0]: p for p in selfcheck.batched_problems(torch.device("cuda"), 8, dict(SMALL, lm=256))}


@pytest.mark.gpu
@pytest.mark.parametrize("case", BATCHED)
def test_batched_kernel_matches_plain_per_problem(case):
    """One launch for the eight problems; each problem's result is bit for
    bit the kernel's on that problem launched alone, and agrees with the
    plain version run on it, within ``selfcheck.agrees``'s tolerance."""
    _cuda()
    name, stacked, kw, problems = _batched_problems()[case]
    module = MODULES[case.split("[")[0]]
    before = module.launches
    got = selfcheck.batched_call(name, stacked, kw)()
    torch.cuda.synchronize()
    assert module.launches == before + 1
    for s, p in enumerate(problems):
        kernel, plain = selfcheck.case_calls(case, p, kw)
        assert selfcheck.max_abs_err(selfcheck.pick(got, s), kernel()) == 0.0, (case, s)
        err, ok = selfcheck.agrees(case, selfcheck.pick(got, s), plain())
        assert ok, (case, s, err)


@pytest.mark.gpu
def test_multi_sequence_system_on_the_card():
    """``MultiSequenceSystem`` (the card by default) over two textures of the
    KITTI-sized ridge scene (``chip_smoke.MULTI_SEEDS``' first two), chunks
    of two supersteps: every frame tracked
    with the keyframe cadence; over the joint chunks K1 launched four times a
    frame step and K2, K3, K4 once, for both sequences together, with no
    plain version on a CUDA tensor; each sequence gives the results of its
    ``DeviceSystem`` run alone."""
    from sdvo_tpu_torch.config import load_config
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences
    from sdvo_tpu_torch.parallel import MultiSequenceSystem
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    _cuda()
    config = load_config(overrides={  # bench.py's
        "initialization": {"disparity_threshold": 3, "threshold_gradient_magnitude": 20}})
    seqs = [r[0] for r in render_bench_sequences((0, 4), 2 + 2 * 6 + 3)]
    ms = MultiSequenceSystem(config, 2, supersteps_per_chunk=2)
    ms.bootstrap(seqs)
    before = {k: (m.launches, m.plain_cuda_calls) for k, m in MODULES.items()}
    ms.joint(seqs)
    launches = {k: m.launches - before[k][0] for k, m in MODULES.items()}
    results = ms.tail(seqs)
    steps = ms.frame_steps
    assert steps == 12
    assert launches == {"lm_align_level": 4 * steps, "fa_align_batch": steps, "pose_refine": steps,
                        "depth_scores": steps}, launches
    assert all(m.plain_cuda_calls == before[k][1] for k, m in MODULES.items())
    for seq, res in zip(seqs, results):
        got = [m["result"] for m in res["metrics"]]
        assert got == ["KEYFRAME", "KEYFRAME"] + ["SUCCESS", "SUCCESS", "KEYFRAME"] * 5, got
        alone = DeviceSystem(config, supersteps_per_chunk=2)
        for i, f in enumerate(seq):
            alone.add_image(f, float(i))
        alone.finish()
        assert [m["result"] for m in alone.metrics] == got


@pytest.mark.gpu
def test_device_system_gives_the_same_bits_every_run():
    """``DeviceSystem`` runs deterministic on the card without the caller
    doing anything: two runs over the KITTI-sized ridge scene (texture 0,
    2 + 12 frames, chunks of two supersteps) give the same trajectory bit
    for bit, and the process has a fixed cuBLAS workspace (the package sets
    ``:4096:8`` unless the caller set one)."""
    import os

    import numpy as np

    from sdvo_tpu_torch.config import load_config
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    _cuda()
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") in (":4096:8", ":16:8")  # cuBLAS's two fixed ones
    config = load_config(overrides={  # bench.py's
        "initialization": {"disparity_threshold": 3, "threshold_gradient_magnitude": 20}})
    frames = render_bench_sequences((0,), 2 + 2 * 6)[0][0]
    runs = []
    for _ in range(2):
        ds = DeviceSystem(config, supersteps_per_chunk=2)
        for i, f in enumerate(frames):
            ds.add_image(f, float(i))
        ds.finish()
        assert not torch.are_deterministic_algorithms_enabled()  # the mode ends with the chunk
        runs.append(np.asarray(ds.trajectory))
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.gpu
def test_multi_sequence_members_are_isolated_on_the_card():
    """Each sequence owns its map on the card as on the CPU: in the mode
    ``MultiSequenceSystem`` runs in (deterministic algorithms on the card),
    sequence 0 (texture 0 of the KITTI-sized ridge scene) gets the same bits
    beside texture 4 as beside texture 12 over two joint chunks of two
    supersteps; and textures 0 and 4, bootstrapped once, get the same frame
    outputs and final state bits from those chunks in either slot
    (``chip_smoke.joint_by_slot``): no op of the vmapped superstep rounds a
    member by its place in the batch (``se3``'s 3×3 products are a multiply
    and a sum; a batched cuBLAS product there did)."""
    import numpy as np

    import chip_smoke
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences
    from sdvo_tpu_torch.parallel import MultiSequenceSystem

    _cuda()
    x, y, z = [r[0] for r in render_bench_sequences((0, 4, 12), 2 + 2 * 6)]

    def run(pair):
        return MultiSequenceSystem(chip_smoke.bench_config(), 2, supersteps_per_chunk=2).run(pair)

    a, b = run([x, y]), run([x, z])
    np.testing.assert_array_equal(np.asarray(a[0]["trajectory"]), np.asarray(b[0]["trajectory"]))
    in01, in10 = chip_smoke.joint_by_slot([x, y], 2, 2)
    for i in range(2):
        assert chip_smoke.same_bits(in01[i], in10[i]), i


@pytest.mark.gpu
def test_streaming_chunk_matches_plain_versions_on_the_card(monkeypatch):
    """One ``StreamingTracker`` chunk on the card (the scene of
    ``tests/test_torch_streaming.py``: 160×120, five frames, 64 features, 32
    matches, 16 filters, three levels) through the kernels, against the same
    chunk through the plain versions on the same card (the tracker's callees
    given the plain functions): the poses put every feature within 0.01 px of
    each other on all frames but one and within 0.15 px on every frame
    (the CPU test's tolerances: K1's rounding can take the LM another way
    at a stall test); K1 launched once a level of a frame, K2 and K4 once a
    frame, and none of them through the plain versions."""
    import numpy as np

    import sdvo_tpu_torch.align.feature_alignment as fa_mod
    import sdvo_tpu_torch.align.image_alignment as ia_mod
    import sdvo_tpu_torch.depth.epipolar as ep_mod
    from sdvo_tpu_torch.align.image_alignment import AlignFeatures, SparseImageAlign
    from sdvo_tpu_torch.dataio.synthetic import render_plane_track
    from sdvo_tpu_torch.depth.filter import init_filters
    from sdvo_tpu_torch.geometry.se3 import SE3
    from sdvo_tpu_torch.image.interp import extract_patches
    from sdvo_tpu_torch.image.pyramid import build_pyramid
    from sdvo_tpu_torch.pipeline.streaming import StreamingTracker

    dev = _cuda()
    F, N, M, C, levels = 5, 64, 32, 16, 3
    cam = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
    sc = render_plane_track(np.random.default_rng(42), cam, [0.08, 0.01, 0.05, 0.001, 0.004, 0.0008], F, N, C)
    pyr = build_pyramid(torch.from_numpy(sc.ref).to(dev), levels)
    feats = AlignFeatures(torch.from_numpy(sc.uv).to(dev), torch.zeros(N, dtype=torch.int32, device=dev),
                          torch.from_numpy(sc.points).to(dev), torch.ones(N, dtype=torch.bool, device=dev))
    fuv = torch.from_numpy(sc.filter_uv).to(dev)
    patches, _ = extract_patches(pyr.base_image, fuv, 7)
    bank = init_filters(fuv, torch.from_numpy(sc.filter_bearing).to(dev), patches, 0, 9.0, 4.0, 0,
                        torch.arange(C, device=dev) < 12)

    def chunk():
        tracker = StreamingTracker(SparseImageAlign(patch_size=5, min_level=0, max_level=levels - 1),
                                   levels=levels)
        assert tracker.device.type == "cuda"
        _, out = tracker.track_chunk(sc.frames, [im[None] for im in pyr.images], pyr.base_gradient, feats,
                                     feats.uv_host[:M], torch.ones(M, dtype=torch.bool, device=dev),
                                     SE3.identity(device=dev), SE3.identity(device=dev), bank,
                                     cam["fx"], cam["fy"], cam["cx"], cam["cy"], 0)
        return out

    def projected(out):
        R = out.rotations.double().cpu().numpy()
        t = out.translations.double().cpu().numpy()
        p = np.einsum("fij,nj->fni", R, sc.points.astype(np.float64)) + t[:, None]
        return np.stack([cam["fx"] * p[..., 0] / p[..., 2] + cam["cx"],
                         cam["fy"] * p[..., 1] / p[..., 2] + cam["cy"]], -1)

    before = {k: m.launches for k, m in MODULES.items()}
    kernels = chunk()
    torch.cuda.synchronize()
    launches = {k: m.launches - before[k] for k, m in MODULES.items()}
    assert launches == {"lm_align_level": levels * F, "fa_align_batch": F, "pose_refine": 0,
                        "depth_scores": F}, launches
    monkeypatch.setattr(ia_mod, "lm_align_level", lm_align.lm_align_level_plain)
    monkeypatch.setattr(fa_mod, "fa_align_batch", fa_align.fa_align_batch_plain)
    monkeypatch.setattr(ep_mod, "depth_scores", depth_scores.depth_scores_plain)
    before = {k: m.launches for k, m in MODULES.items()}
    plain = chunk()
    assert all(m.launches == before[k] for k, m in MODULES.items())
    gaps = np.abs(projected(kernels) - projected(plain)).max(axis=(1, 2))
    assert gaps.max() < 0.15 and (gaps < 0.01).sum() >= F - 1, gaps
