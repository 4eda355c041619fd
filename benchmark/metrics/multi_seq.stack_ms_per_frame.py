"""multi_seq.stack_ms_per_frame: Σ of the port's ``multi_seq.stack`` spans (the
per-sequence stack, conversion, transpose and contiguous copy) in the window,
the traced slice left out, in ms a frame of every stream."""

from benchmark.harness.program import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "multi_seq.stack", "multi_seq")
