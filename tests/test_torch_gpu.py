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
    # the joint chunks replay one CUDA graph; its capture's warm-up launched too
    (graph,) = ms.chunk_fn.graph.graphs.values()
    launches = {k: m.launches - before[k][0] - graph.warmup_launches[k] for k, m in MODULES.items()}
    results = ms.tail(seqs)
    steps = ms.frame_steps
    assert steps == 12 and graph.replays == 2
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

    def chunk():  # the eager loop: each launch counts once, no capture's warm-up
        tracker = StreamingTracker(SparseImageAlign(patch_size=5, min_level=0, max_level=levels - 1),
                                   levels=levels)
        assert tracker.device.type == "cuda"
        _, out = tracker.track_chunk_eager(sc.frames, [im[None] for im in pyr.images], pyr.base_gradient, feats,
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


# ------------------------------------------------- the chunks as CUDA graphs
BENCH_OVERRIDES = {"initialization": {"disparity_threshold": 3, "threshold_gradient_magnitude": 20}}


def _bootstrapped_on_card(supersteps: int = 2, n_chunks: int = 2):
    """A ``DeviceSystem`` on the card bootstrapped on texture 0 of the
    KITTI-sized ridge scene (chunks of ``supersteps`` supersteps), and the
    next ``n_chunks`` chunks' frames on the card, (C, 3, H, W) each."""
    import numpy as np

    from sdvo_tpu_torch.config import load_config
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    n = 3 * supersteps
    frames = render_bench_sequences((0,), 2 + n_chunks * n)[0][0]
    ds = DeviceSystem(load_config(overrides=BENCH_OVERRIDES), supersteps_per_chunk=supersteps)
    ds.add_image(frames[0], 0.0)
    ds.add_image(frames[1], 1.0)
    assert ds.bootstrapped
    H, W = frames[0].shape
    chunks = [torch.from_numpy(np.stack(frames[2 + c * n:2 + (c + 1) * n])).to(ds.device).reshape(supersteps, 3, H, W)
              for c in range(n_chunks)]
    return ds, chunks


def _same_bits(a, b) -> bool:
    from sdvo_tpu_torch.pipeline.cuda_graph import flatten

    la, lb = flatten(a)[0], flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.contiguous().view(-1).view(torch.uint8), y.contiguous().view(-1).view(torch.uint8)) for x, y in zip(la, lb))


@pytest.mark.gpu
def test_graphed_run_chunk_matches_the_eager_loop():
    """``DeviceVO.run_chunk`` on the card replays one captured chunk: two
    chunks in a row give the eager loop's state and outputs bit for bit, and
    a replay launches each kernel as often as the eager chunk (K1 four times
    a frame, K2–K4 once)."""
    from sdvo_tpu_torch.device import deterministic_on

    _cuda()
    ds, (c0, c1) = _bootstrapped_on_card()
    vo = ds.vo
    with deterministic_on(ds.device):
        g1 = vo.run_chunk(ds.state, c0)
        g2 = vo.run_chunk(g1[0], c1)
        e1 = vo.run_chunk_eager(ds.state, c0)
        e2 = vo.run_chunk_eager(e1[0], c1)
    torch.cuda.synchronize()
    assert _same_bits(g1, e1) and _same_bits(g2, e2)
    (graph,) = vo.chunk_graph.graphs.values()
    assert not vo.step_graph.graphs and graph.replays == 2
    assert graph.captured_launches == {"lm_align_level": 24, "fa_align_batch": 6, "pose_refine": 6,
                                       "depth_scores": 6}, graph.captured_launches


@pytest.mark.gpu
def test_chunk_fn_replays_one_graph_for_each_length():
    """``DeviceVO.chunk_fn(n)`` for n = 1, 2, 3 on the card: the same
    callable for equal n, one graph of ``chunk_graph`` for each n, replayed
    at its second call, each chunk bit for bit the eager loop's from the
    same state."""
    from sdvo_tpu_torch.device import deterministic_on

    _cuda()
    ds, (chunk,) = _bootstrapped_on_card(supersteps=3, n_chunks=1)
    vo = ds.vo
    with deterministic_on(ds.device):
        for n in (1, 2, 3):
            fn = vo.chunk_fn(n)
            assert fn is vo.chunk_fn(n)
            first, again = fn(ds.state, chunk[:n]), fn(ds.state, chunk[:n])
            eager = vo.run_chunk_eager(ds.state, chunk[:n])
            torch.cuda.synchronize()
            assert _same_bits(first, eager) and _same_bits(again, eager), n
    graphs = list(vo.chunk_graph.graphs.values())
    assert not vo.step_graph.graphs and [g.replays for g in graphs] == [2, 2, 2]
    assert [g.captured_launches["depth_scores"] for g in graphs] == [3, 6, 9]


@pytest.mark.gpu
def test_device_system_in_float64_on_the_card():
    """``compute_dtype="float64"`` on the card: a float64 state whose chunks
    replay their CUDA graph (the kernels compute in float32 inside), the
    same trajectory bits in two runs, and the main path's gates (no failed
    frame, keyframe cadence, ATE < 0.10 m, drift < 1.5 %) over 2 + 12
    frames in chunks of two supersteps."""
    import chip_smoke
    from sdvo_tpu_torch.config import load_config
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    _cuda()
    frames, T_true = render_bench_sequences((0,), 2 + 2 * 6)[0]

    def run():
        ds = DeviceSystem(load_config(overrides=BENCH_OVERRIDES).replace(compute_dtype="float64"),
                          supersteps_per_chunk=2)
        for i, f in enumerate(frames):
            ds.add_image(f, float(i))
        ds.finish()
        return ds

    a, b = run(), run()
    assert a.device.type == "cuda"
    assert a.state.map.pt_pos.dtype == a.state.ref.T_ref_w.translation.dtype == torch.float64
    (graph,) = a.vo.chunk_graph.graphs.values()
    assert graph.replays == 2 and not a.vo.step_graph.graphs
    assert chip_smoke.trajectory_digest(a.trajectory) == chip_smoke.trajectory_digest(b.trajectory)
    *_, broken = chip_smoke.tracking_gates(a.metrics, a.trajectory, T_true)
    assert broken is None, broken


@pytest.mark.gpu
def test_graphed_chunk_hands_back_no_alias():
    """A state kept from chunk 1 is unchanged after chunk 2 has replayed: the
    graph hands back copies, not its static buffers."""
    from sdvo_tpu_torch.device import deterministic_on
    from sdvo_tpu_torch.pipeline.cuda_graph import flatten

    _cuda()
    ds, (c0, c1) = _bootstrapped_on_card()
    with deterministic_on(ds.device):
        g1 = ds.vo.run_chunk(ds.state, c0)
        kept = [x.clone() for x in flatten(g1)[0]]
        ds.vo.run_chunk(g1[0], c1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kept, flatten(g1)[0]))
    static = {x.data_ptr() for x in ds.vo.chunk_graph.last.static_out}
    assert not static & {x.data_ptr() for x in flatten(g1)[0]}


@pytest.mark.gpu
def test_tail_superstep_and_full_chunk_both_graphed():
    """A tail of one superstep replays the captured superstep, a full chunk
    the captured chunk: a ``DeviceVO`` holds those two graphs, and each gives
    the eager loop's bits."""
    from sdvo_tpu_torch.device import deterministic_on

    _cuda()
    ds, (c0, _) = _bootstrapped_on_card()
    vo = ds.vo
    with deterministic_on(ds.device):
        tail = vo.run_chunk(ds.state, c0[:1])
        full = vo.run_chunk(tail[0], c0)
        tail_e = vo.run_chunk_eager(ds.state, c0[:1])
        full_e = vo.run_chunk_eager(tail_e[0], c0)
    torch.cuda.synchronize()
    assert _same_bits(tail, tail_e) and _same_bits(full, full_e)
    (step,), (chunk,) = vo.step_graph.graphs.values(), vo.chunk_graph.graphs.values()
    assert step.replays == 1 and chunk.replays == 1


@pytest.mark.gpu
def test_graphed_streaming_chunk_matches_the_eager_loop():
    """``StreamingTracker.track_chunk`` on the card replays one captured
    chunk of F frames: two chunks give ``track_chunk_eager``'s bits, and a
    replay launches K1 once a level of a frame and K2, K4 once a frame."""
    import numpy as np

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
    sc = render_plane_track(np.random.default_rng(42), cam, [0.08, 0.01, 0.05, 0.001, 0.004, 0.0008], 2 * F, N, C)
    pyr = build_pyramid(torch.from_numpy(sc.ref).to(dev), levels)
    feats = AlignFeatures(torch.from_numpy(sc.uv).to(dev), torch.zeros(N, dtype=torch.int32, device=dev),
                          torch.from_numpy(sc.points).to(dev), torch.ones(N, dtype=torch.bool, device=dev))
    fuv = torch.from_numpy(sc.filter_uv).to(dev)
    patches, _ = extract_patches(pyr.base_image, fuv, 7)
    bank = init_filters(fuv, torch.from_numpy(sc.filter_bearing).to(dev), patches, 0, 9.0, 4.0, 0,
                        torch.arange(C, device=dev) < 12)
    tracker = StreamingTracker(SparseImageAlign(patch_size=5, min_level=0, max_level=levels - 1), levels=levels)
    fixed = ([im[None] for im in pyr.images], pyr.base_gradient, feats, feats.uv_host[:M],
             torch.ones(M, dtype=torch.bool, device=dev))

    def two_chunks(track):
        eye = SE3.identity(device=dev)
        carry, out1 = track(sc.frames[:F], *fixed, eye, eye, bank, cam["fx"], cam["fy"], cam["cx"], cam["cy"], 0)
        return track(sc.frames[F:], *fixed, *carry, cam["fx"], cam["fy"], cam["cx"], cam["cy"], 0), out1

    graphed = two_chunks(tracker.track_chunk)
    eager = two_chunks(tracker.track_chunk_eager)
    torch.cuda.synchronize()
    assert _same_bits(graphed, eager)
    (graph,) = tracker.graph.graphs.values()
    assert graph.replays == 2
    assert graph.captured_launches == {"lm_align_level": levels * F, "fa_align_batch": F, "pose_refine": 0,
                                       "depth_scores": F}, graph.captured_launches


@pytest.mark.gpu
def test_graphed_joint_chunk_matches_the_eager_loop():
    """The multi-sequence joint chunk (two textures of the KITTI-sized ridge
    scene, chunks of two supersteps) replays its CUDA graph of the vmapped
    supersteps and gives ``chunk_fn.eager``'s bits."""
    import numpy as np

    from sdvo_tpu_torch.config import load_config
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences
    from sdvo_tpu_torch.device import deterministic_on
    from sdvo_tpu_torch.parallel import MultiSequenceSystem

    _cuda()
    seqs = [r[0] for r in render_bench_sequences((0, 4), 2 + 6)]
    ms = MultiSequenceSystem(load_config(overrides=BENCH_OVERRIDES), 2, supersteps_per_chunk=2)
    ms.bootstrap([s[:2] for s in seqs])
    imgs = np.stack([np.stack(s[2:8]) for s in seqs]).reshape(2, 2, 3, *seqs[0][0].shape)
    imgs = torch.from_numpy(np.ascontiguousarray(imgs.transpose(1, 0, 2, 3, 4))).cuda()
    with deterministic_on(imgs.device):
        graphed = ms.chunk_fn(ms._state, imgs)
        again = ms.chunk_fn(ms._state, imgs)
        eager = ms.chunk_fn.eager(ms._state, imgs)
    torch.cuda.synchronize()
    assert _same_bits(graphed, eager) and _same_bits(graphed, again)
    (graph,) = ms.chunk_fn.graph.graphs.values()
    assert graph.replays == 2


@pytest.mark.gpu
def test_a_capture_that_fails_raises():
    """No fallback: a function that reads a device value on the host cannot
    be captured, and ``GraphedCall`` raises instead of running it eagerly."""
    from sdvo_tpu_torch.pipeline.cuda_graph import GraphedCall

    dev = _cuda()
    call = GraphedCall(lambda x: x * float(x.sum()), "host-read")
    with pytest.raises(RuntimeError, match="host-read: CUDA graph capture failed"):
        call(torch.ones(4, device=dev))
    assert call.graphs == {}


@pytest.mark.gpu
def test_a_mode_flip_captures_its_own_graph():
    """A chunk run in PyTorch's default mode after one in the deterministic
    mode does not replay the deterministic graph: it captures its own, which
    gives the eager loop's bits in that mode, and a return to the
    deterministic mode replays the first graph again."""
    from sdvo_tpu_torch.device import deterministic_on

    _cuda()
    ds, (c0, _) = _bootstrapped_on_card()
    vo = ds.vo
    with deterministic_on(ds.device):
        det = vo.run_chunk(ds.state, c0)
        det_eager = vo.run_chunk_eager(ds.state, c0)
    default = vo.run_chunk(ds.state, c0)
    with deterministic_on(ds.device):
        det_again = vo.run_chunk(ds.state, c0)
    torch.cuda.synchronize()
    assert _same_bits(det, det_eager) and _same_bits(det, det_again)
    first, second = vo.chunk_graph.graphs.values()
    assert first.replays == 2 and second.replays == 1
    # the default mode sums by atomics in any order: its own bits, every frame tracked
    assert bool(default[1].ok.all()) and bool(torch.isfinite(default[1].t).all())


@pytest.mark.gpu
@pytest.mark.parametrize("level", range(4))
def test_lm_kernel_freeze_sigma_matches_plain_on_card(level):
    """K1 with ``freeze_sigma`` (``selfcheck.freeze_problems``, the device
    path's shape and iterations): the kernel against its plain version, and
    another solve than the unfrozen one."""
    dev = _cuda()
    name, args, kw = selfcheck.freeze_problems(dev)[level]
    kernel, plain = selfcheck.case_calls(name, args, kw)
    got = kernel()
    torch.cuda.synchronize()
    err, ok = selfcheck.agrees(name, got, plain())
    assert ok, (name, err)
    unfrozen = selfcheck.case_calls(name, args, {k: v for k, v in kw.items() if k != "freeze_sigma"})[0]()
    assert not torch.equal(unfrozen[1], got[1]) or not torch.equal(unfrozen[0].translation, got[0].translation)


@pytest.mark.gpu
def test_long_run_on_the_card():
    """``chip_smoke.run_long``: the JAX package's long run (300 frames,
    black 150-158) through ``DeviceSystem`` on the card, every gate of
    ``tests/test_long_sequence.py``, two graphed runs with one digest, the
    relocalization re-packed into the chunk graph captured before the
    blackout."""
    import chip_smoke

    _cuda()
    launches = chip_smoke.run_long(selfcheck.card_line())
    assert all(n > 0 for n in launches.values())


@pytest.mark.gpu
def test_euroc_on_the_card():
    """``chip_smoke.run_euroc``: BASELINE config 2 at 5 levels, ``System``
    with ``tests/test_euroc.py``'s gates and K1 five launches a frame, and
    ``DeviceSystem`` with no failed frame, exact cadence, the 4/4/6/8/10
    schedule and one digest in two graphed runs."""
    import chip_smoke

    _cuda()
    sys_launches, dev_launches = chip_smoke.run_euroc(selfcheck.card_line())
    assert sys_launches["lm_align_level"] == chip_smoke.EUROC_LEVELS * (chip_smoke.EUROC_SYSTEM_FRAMES - 2)
    assert dev_launches["lm_align_level"] % chip_smoke.EUROC_LEVELS == 0 and dev_launches["lm_align_level"] > 0


@pytest.mark.gpu
def test_a_graph_collected_during_a_capture_does_not_break_it():
    """A dropped object that holds a captured graph in a reference cycle (a
    dropped ``DeviceSystem``: its ``DeviceVO`` and ``GraphedCall`` refer to
    each other) waits for Python's cyclic collector, which resets the graph.
    A reset during another capture invalidated that capture (``run_euroc``
    after ``run_long``'s systems were dropped). Here two such holders become
    garbage inside the capture, with the collector run at nearly every
    allocation: the capture holds, and the holders go at the next collection."""
    import gc
    import weakref

    from sdvo_tpu_torch.pipeline.cuda_graph import GraphedCall

    dev = _cuda()
    x = torch.linspace(0.0, 1.0, 4096, device=dev)

    class Holder:
        pass

    keep = []
    for _ in range(2):
        h = Holder()
        h.me = h
        h.call = GraphedCall(lambda t: t * 2 + 1, "dropped")
        h.call(x)
        keep.append(h)
    del h
    gone = [weakref.ref(k) for k in keep]
    calls = []

    def fn(t):
        calls.append(1)
        if len(calls) == 2:  # the capture (the first call is the warm-up): the holders become garbage
            keep.clear()
            # objects that live until the capture ends: enough of them that a full
            # collection falls due (it waits for a quarter of the long-lived objects)
            _ = [[i] for i in range(500_000)]
        return (t.sin() * 2).cumsum(0)

    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        out = GraphedCall(fn, "live")(x)
    finally:
        gc.set_threshold(*old)
    torch.testing.assert_close(out, (x.sin() * 2).cumsum(0))
    gc.collect()
    assert all(r() is None for r in gone)


def _tools():
    """The repository's root and ``tools/`` on the path, for the measurement
    entry points."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in (os.path.join(root, "tools"), root):
        if path not in sys.path:
            sys.path.insert(0, path)


@pytest.mark.gpu
def test_bench_protocol_on_the_card():
    """``bench_torch.run_protocol`` at its shortest (chunks of one superstep,
    a warm-up chunk and one group of two) on the card: one chunk graph
    replayed once a chunk, finite gate values, its pool reported; and the
    proxy of the baseline builds and runs on the card's machine."""
    import tempfile

    import numpy as np

    _tools()
    import bench_torch
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequence
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    _cuda()
    frames, T_true = render_bench_sequence(np.random.default_rng(0), 2 + 3 * 3)
    ds = DeviceSystem(bench_torch.bench_config(), supersteps_per_chunk=1)
    res = bench_torch.run_protocol(ds, frames, T_true, supersteps=1, groups=1, timed=2)
    (graph,) = ds.vo.chunk_graph.graphs.values()
    assert graph.replays == 3 and res["pool_bytes"] == graph.pool_bytes > 0
    assert res["frames"] == 9 and res["failed_frames"] == 0 and res["keyframes"] == 3
    assert np.isfinite([res["ate_m"], res["drift"]] + res["fps_chunks"]).all()
    with tempfile.TemporaryDirectory() as tmp:
        (fps,) = bench_torch.run_proxy(bench_torch.build_proxy(tmp), runs=1)
    assert fps > 0


@pytest.mark.gpu
def test_bench_multiseq_on_the_card():
    """``bench_multiseq_torch`` at its shortest (S = 2, chunks of one
    superstep, a warm-up and one timed chunk) on the card: the JAX tool's
    gates hold, and the aggregate is S times the per-sequence rate."""
    import numpy as np

    _tools()
    import bench_multiseq_torch
    from bench_torch import bench_config
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    _cuda()
    # texture 1 bootstraps on frame 2 on the card: the tool's slack of frames
    seqs = [r[0] for r in render_bench_sequences((0, 1), 2 + 2 * 3 + bench_multiseq_torch.BOOT_SLACK)]
    subs = bench_multiseq_torch.bootstrap(seqs, lambda: DeviceSystem(bench_config(), supersteps_per_chunk=1))
    res = bench_multiseq_torch.run(subs, seqs, 1, 1)
    assert res["broken"] is None and res["pool_bytes"] > 0
    assert res["per_seq_fps"] * 2 == res["value"] and np.isfinite(res["value"])


@pytest.mark.gpu
def test_profile_system_on_the_card():
    """``profile_system_torch`` at its shortest (2 chained calls a graph, one
    timed replay) on the card: every stage timed, each launching the port's
    kernels as the frame step does (``chip_smoke.PROFILE_OWN``)."""
    import numpy as np

    _tools()
    import chip_smoke
    import profile_system_torch
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequence
    from sdvo_tpu_torch.device import deterministic_on

    _cuda()
    frames, _ = render_bench_sequence(np.random.default_rng(0), profile_system_torch.N_FRAMES)
    ds, image = profile_system_torch.setup(frames, None)
    with deterministic_on(ds.device):
        rows = profile_system_torch.profile(ds.vo, ds.state, image, reps=2, replays=1)
    for r in rows:
        assert r["ms"] > 0 and r["kernels"] > 0, r
        assert tuple(r["own"][k] for k in chip_smoke.KERNEL_SYMBOLS) == chip_smoke.PROFILE_OWN[r["stage"]], r


@pytest.mark.gpu
def test_profile_ablate_on_the_card():
    """``profile_ablate_torch`` at its shortest (chunks of one superstep, one
    timed call) on the card: every ablation captured and timed, each
    launching the port's kernels as ``chip_smoke.ABLATE_OWN`` says, and no
    stub left behind."""
    import numpy as np

    _tools()
    import chip_smoke
    import profile_ablate_torch
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequence
    from sdvo_tpu_torch.device import deterministic_on

    _cuda()
    frames, _ = render_bench_sequence(np.random.default_rng(0), 2 + 3 * 3)
    originals = [vars(ns)[a] for ts in profile_ablate_torch.ablations().values() for ns, a, _ in ts]
    ds, state, chunk = profile_ablate_torch.setup(frames, None, supersteps=1)
    with deterministic_on(ds.device):
        rows = profile_ablate_torch.run_ablations(ds.vo, state, chunk, 1, replays=1)
    assert [vars(ns)[a] for ts in profile_ablate_torch.ablations().values() for ns, a, _ in ts] == originals
    for r in rows:
        assert r["ms_frame"] > 0, r
        assert tuple(r["own_frame"][k] for k in chip_smoke.KERNEL_SYMBOLS) == chip_smoke.ABLATE_OWN[r["run"]], r
