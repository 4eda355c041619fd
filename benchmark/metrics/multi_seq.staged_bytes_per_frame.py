"""multi_seq.staged_bytes_per_frame: the port's counters
``multi_seq.staged_bytes`` / ``multi_seq.staged_frames`` added in the
window: the bytes the joint phase copies to the card a stream-frame it
stages (H·W where it stages 8-bit frames as 8-bit, 4·H·W where it stages
float32). A port without the counters reads nothing."""

from benchmark.harness.program import ratio


def read(run):
    return ratio(run, "multi_seq.staged_bytes", "multi_seq.staged_frames")
