"""fa_align_batch_roofline: the kernel's share of its roofline in the traced slice:
Σ its launches' least time (``benchmark/harness/roofline.py``, at the
shapes recorded in the warm-up) / Σ its kernel time, in %."""

from benchmark.harness.roofline import share


def read(run):
    return share(run, "fa_align_batch")
