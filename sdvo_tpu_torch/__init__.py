"""sdvo_tpu_torch — the PyTorch/CUDA port of sdvo_tpu for NVIDIA Hopper.

The JAX package ``sdvo_tpu`` is the reference; this package mirrors its
layout module for module and never imports it (nor JAX). Plain tensor code is
PyTorch; the four Pallas kernels of the device main path are hand-written
CUDA C++ for ``sm_90a`` under ``csrc/`` (built on first use, see
``sdvo_tpu_torch.ops.build``), each with a plain PyTorch version beside its
wrapper for CPU tensors and for parity checks.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry correctness over matmul throughput, as sdvo_tpu/__init__.py forces
# full-f32 dots: TF32 keeps ~3 decimal digits, which at scene scale injects
# centimetre-level rounding into every pose application and Hessian.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from sdvo_tpu_torch.config import Config, load_config  # noqa: E402,F401
