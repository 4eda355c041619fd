"""device_system.buffer_ms_per_frame.live: Σ of the port's
``device_system.buffer`` spans (the buffering ``add_image`` calls' conversion
and append) in the window, the traced slice left out, in ms a frame."""

from benchmark.harness.program import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "device_system.buffer", "device_system")
