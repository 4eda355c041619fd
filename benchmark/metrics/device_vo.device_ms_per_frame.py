"""device_vo.device_ms_per_frame: the union of the device's kernel
intervals in the traced slice over the frames it holds (every stream's)."""


def read(run):
    s = run.slice
    if s is None or not s.kernels or s.frames <= 0:
        return None
    return 1e3 * s.busy_s / s.frames
