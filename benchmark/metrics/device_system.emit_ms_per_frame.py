"""device_system.emit_ms_per_frame: Σ of the port's ``device_system.emit`` spans
(``_dispatch``'s copies out and ``_emit`` (after a synchronize)) in the window,
the traced slice left out, in ms a frame."""

from benchmark.harness.program import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "device_system.emit", "device_system")
