"""State carried across implementations: the reference's ``VOState`` ↔ the
port's.

``vo_state_from_numpy`` takes a ``VOState`` of the JAX package after
``jax.device_get`` — a nested NamedTuple of numpy arrays — and builds the
port's ``VOState`` field by field on ``device``, keeping every dtype. The
match is by NamedTuple class name and field name, so nothing of the JAX
package is imported. ``to_numpy`` goes the other way: the port's state as
the same nested NamedTuples holding numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from sdvo_tpu_torch.align.image_alignment import AlignFeatures
from sdvo_tpu_torch.depth.filter import FilterBank
from sdvo_tpu_torch.device import resolve_device
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.mapping.device_map import DeviceMap
from sdvo_tpu_torch.pipeline.device_system import DeviceFilters, TrackRef, VOState

_TYPES = {cls.__name__: cls for cls in (VOState, DeviceMap, DeviceFilters, FilterBank, TrackRef,
                                        SE3, AlignFeatures)}


def vo_state_from_numpy(tree, device=None) -> VOState:
    """JAX ``VOState`` (numpy leaves) → the port's ``VOState`` on ``device``
    (the CUDA card by default, raising where there is none; ``device="cpu"``
    asks for the CPU)."""
    device = resolve_device(device)
    if hasattr(tree, "_fields"):
        cls = _TYPES[type(tree).__name__]
        return cls(*[vo_state_from_numpy(getattr(tree, f), device) for f in cls._fields])
    if isinstance(tree, (tuple, list)):
        return tuple(vo_state_from_numpy(x, device) for x in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def to_numpy(tree):
    """The port's state (any nested NamedTuple of tensors) → numpy leaves."""
    if hasattr(tree, "_fields"):
        return type(tree)(*[to_numpy(x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return tuple(to_numpy(x) for x in tree)
    return tree.detach().cpu().numpy()
