"""device_system.bootstrap_s: Σ of the port's ``device_system.bootstrap`` spans
before the window (the host ``System`` frames until ``_pack``, ``_pack``
included), over every stream, in s."""

from benchmark.harness.program import program


def read(run):
    p = program(run)
    if p is None or "device_system.bootstrap" not in p.setup:
        return None
    return p.setup["device_system.bootstrap"][0]
