"""The benchmark's plain reference: the port's superstep and the packing of
its start, as plain PyTorch, frozen.

A copy of the parts of ``sdvo_tpu_torch`` that ``DeviceVO.superstep`` and
``DeviceSystem._pack`` reach, and nothing else (no host ``System``, no
bootstrap, no chunk loop), with three changes: the imports name this
package; each of the four kernels' wrappers (``ops/lm_align.py``,
``ops/fa_align.py``, ``ops/pose_refine.py``, ``ops/depth_scores.py``) calls
its plain version on every device, so no CUDA kernel is built or launched;
``_pack`` is the free function ``pipeline.device_system.pack``. Later
changes to the port do not reach it: it is the yardstick the timed path's
outputs are held to (``benchmark/harness/check.py``). It sets no
process-wide switch when imported; the harness sets TF32 itself.

The harness takes from a reference package only the names of ``__all__``,
from the package itself: a configuration's file names its reference by a
dotted name (``reference``, this package by default), and a configuration
that changes part of the superstep brings a package that re-exports these
names (``from benchmark.reference import *``) and overrides the ones it
changes.
"""

from benchmark.reference import device as _device  # noqa: F401  (sets CUBLAS_WORKSPACE_CONFIG)
from benchmark.reference.align.image_alignment import AlignFeatures
from benchmark.reference.config import Config, load_config
from benchmark.reference.depth.filter import FilterBank
from benchmark.reference.device import deterministic_on
from benchmark.reference.geometry.camera import PinholeCamera
from benchmark.reference.geometry.se3 import SE3
from benchmark.reference.image.pyramid import ImagePyramid
from benchmark.reference.mapping.device_map import DeviceMap
from benchmark.reference.pipeline.device_system import (DeviceFilters, DeviceVO, TrackRef, VOState, pack,
                                                        superstep_config)

# the classes of the program's state, by name: the check rebuilds the program's state in them
STATE_CLASSES = (AlignFeatures, FilterBank, SE3, ImagePyramid, DeviceMap, DeviceFilters, TrackRef, VOState)

__all__ = ["Config", "DeviceVO", "PinholeCamera", "STATE_CLASSES", "deterministic_on", "load_config", "pack",
           "superstep_config"]
