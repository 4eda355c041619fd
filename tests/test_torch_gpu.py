"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card (marker ``gpu``; every test skips without one).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
The problems are ``sdvo_tpu_torch.ops.selfcheck``'s, at small sizes; the
tolerances are ``selfcheck.agrees``'s.
"""

import pytest
import torch

from sdvo_tpu_torch.ops import fa_align, selfcheck

SMALL = {"lm": 64, "fa": 32, "pose": 40, "depth_filters": 64}
CASES = ["lm_align_level[L0]", "lm_align_level[L1]", "lm_align_level[L2]", "lm_align_level[L3]",
         "fa_align_batch", "pose_refine", "depth_scores"]


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


# K1 and K3 at the sizes their thread mappings make interesting
# (``selfcheck.extra_problems``), the all-invisible cases included
EXTRA = ["lm_align_level[N37]", "lm_align_level[N300]", "lm_align_level[patch4]",
         "lm_align_level[N37-blind]", "pose_refine[N1]", "pose_refine[N33]", "pose_refine[N500]",
         "pose_refine[N1500]", "pose_refine[N33-blind]"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", EXTRA)
def test_lm_kernel_matches_plain_at_extra_shapes(case):
    """Synchronised after the kernel, so that a hang or a fault shows here."""
    dev = _cuda()
    problem, = [p for p in selfcheck.extra_problems(dev) if p[0] == case]
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
