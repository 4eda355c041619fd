"""device_vo.ba_ms_per_keyframe.live: device ms a keyframe step of
``device_vo.kf.ba`` (``DeviceVO._run_ba``) in the traced slice's graph replays,
by the graph's stage map."""

from benchmark.harness.program import stage_ms


def read(run):
    return stage_ms(run, ("device_vo.kf.ba",), "keyframe")
