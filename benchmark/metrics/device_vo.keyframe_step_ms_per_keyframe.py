"""device_vo.keyframe_step_ms_per_keyframe: device ms a keyframe step (a superstep
of every stream) of the keyframe step's six stages in the traced slice's graph
replays, by the graph's stage map."""

from benchmark.harness.program import FRAME_STAGES, KEYFRAME_STAGES, stage_ms


def read(run):
    return stage_ms(run, KEYFRAME_STAGES, "keyframe")
