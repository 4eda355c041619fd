"""device_vo.device_ms_per_superstep.live: the union of the device's kernel
intervals in the traced slice over the supersteps it holds."""


def read(run):
    s = run.slice
    if s is None or not s.kernels or s.supersteps <= 0:
        return None
    return 1e3 * s.busy_s / s.supersteps
