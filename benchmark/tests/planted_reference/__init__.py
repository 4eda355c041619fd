"""``benchmark.reference`` with one planted change, for the test that a
configuration's ``reference`` key is obeyed: every frame's alignment rmse
one grey level above the plain reference's."""

from benchmark.reference import *  # noqa: F401,F403
from benchmark.reference import DeviceVO as _DeviceVO
from benchmark.reference import __all__  # noqa: F401


class DeviceVO(_DeviceVO):
    def superstep(self, state, images):
        st, out = super().superstep(state, images)
        return st, out._replace(rmse=out.rmse + 1.0)
