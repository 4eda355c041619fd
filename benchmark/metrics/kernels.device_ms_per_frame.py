"""kernels.device_ms_per_frame: the four hand-written kernels' (K1–K4)
time in the traced slice, by their names, over the frames it holds."""

from benchmark.harness.roofline import KERNELS


def read(run):
    s = run.slice
    if s is None or s.frames <= 0:
        return None
    by = s.seconds_by_kernel()
    total = sum(sec for name, sec in by.items() if any(sym in name for sym, _ in KERNELS.values()))
    return 1e3 * total / s.frames if total > 0 else None
