"""device_vo.frame_step_ms_per_frame.live: device ms a frame (every stream's) of
the frame step's six stages in the traced slice's graph replays, by the graph's
stage map (``harness/program.py``)."""

from benchmark.harness.program import FRAME_STAGES, stage_ms


def read(run):
    return stage_ms(run, FRAME_STAGES, "frame")
