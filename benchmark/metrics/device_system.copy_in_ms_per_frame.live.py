"""device_system.copy_in_ms_per_frame.live: Σ of the port's
``device_system.copy_in`` spans (``_dispatch``'s copy of the frames to the
card) in the window, the traced slice left out, in ms a frame."""

from benchmark.harness.program import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "device_system.copy_in", "device_system")
