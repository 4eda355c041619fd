"""device_vo.ba_solve_share: the port's counters ``device_vo.ba_solves`` /
``device_vo.keyframe_steps`` added in the window: the keyframe steps whose
windowed BA solved (``do_ba``)."""

from benchmark.harness.program import ratio


def read(run):
    return ratio(run, "device_vo.ba_solves", "device_vo.keyframe_steps")
