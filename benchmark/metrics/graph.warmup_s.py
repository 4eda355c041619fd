"""graph.warmup_s: the port's ``graph.warmup`` span of the CUDA graph the window
replays: the eager run of its capture on the side stream (the rest of
``graph.capture_s`` is the recording), in s."""

from benchmark.harness.program import program


def read(run):
    p = program(run)
    return None if p is None else p.warmup_s
