"""multi_seq.emit_ms_per_frame: Σ of the port's ``multi_seq.emit`` spans (the
copies out and every sequence's ``_emit`` (after a synchronize)) in the window,
the traced slice left out, in ms a frame of every stream."""

from benchmark.harness.program import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "multi_seq.emit", "multi_seq")
