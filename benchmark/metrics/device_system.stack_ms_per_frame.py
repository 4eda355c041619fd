"""device_system.stack_ms_per_frame: Σ of the port's ``device_system.stack`` spans
(``_dispatch``'s ``np.stack`` and reshape) in the window, the traced slice left
out, in ms a frame."""

from benchmark.harness.program import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "device_system.stack", "device_system")
