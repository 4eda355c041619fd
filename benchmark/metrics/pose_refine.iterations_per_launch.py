"""pose_refine.iterations_per_launch: the port's counters
``pose_refine.iterations`` / ``pose_refine.launches`` added in the window: K3's
iterations a launch (a stream of a batched launch counts as one)."""

from benchmark.harness.program import ratio


def read(run):
    return ratio(run, "pose_refine.iterations", "pose_refine.launches")
