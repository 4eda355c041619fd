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

from sdvo_tpu_torch.ops import fa_align, selfcheck

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
