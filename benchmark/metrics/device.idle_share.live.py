"""device.idle_share.live: 1 − the union of kernel intervals / the traced
slice's length."""


def read(run):
    return run.slice.idle_share() if run.slice is not None else None
