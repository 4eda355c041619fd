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
"""

from benchmark.reference import device as _device  # noqa: F401  (sets CUBLAS_WORKSPACE_CONFIG)
from benchmark.reference.config import Config, load_config  # noqa: F401
