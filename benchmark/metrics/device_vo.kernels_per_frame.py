"""device_vo.kernels_per_frame: device kernels (copies aside) in the traced slice over the
frames it holds (every stream's)."""


def read(run):
    s = run.slice
    if s is None or not s.kernels or s.frames <= 0:
        return None
    return s.n_kernels() / s.frames
