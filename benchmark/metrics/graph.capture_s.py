"""graph.capture_s: ``capture_seconds`` of the CUDA graph the window
replays (``GraphedCall``'s ``Capture``: warm-up and capture, host clock)."""


def read(run):
    return run.capture_s if run.capture_s else None
