"""lm_align_level.iterations_per_launch: the port's counters
``lm_align_level.iterations`` / ``lm_align_level.launches`` added in the
window: K1's iterations a launch (a stream of a batched launch counts as one)."""

from benchmark.harness.program import ratio


def read(run):
    return ratio(run, "lm_align_level.iterations", "lm_align_level.launches")
