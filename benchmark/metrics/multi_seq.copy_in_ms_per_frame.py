"""multi_seq.copy_in_ms_per_frame: Σ of the port's ``multi_seq.copy_in`` spans
(the copy of the joint chunk's frames to the card) in the window, the traced
slice left out, in ms a frame of every stream."""

from benchmark.harness.program import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "multi_seq.copy_in", "multi_seq")
