"""State carried across implementations: the reference's ``VOState`` and map
arena ↔ the port's.

``vo_state_from_numpy`` takes a ``VOState`` of the JAX package after
``jax.device_get`` — a nested NamedTuple of numpy arrays — and builds the
port's ``VOState`` field by field on ``device``, keeping every dtype. The
match is by NamedTuple class name and field name, so nothing of the JAX
package is imported. ``to_numpy`` goes the other way: the port's state as
the same nested NamedTuples holding numpy arrays. Both take a stacked
``VOState`` of the multi-sequence path (every leaf with a leading sequence
axis, ``parallel.multi_seq.stack_states``) as they take one sequence's.

``arena_to_numpy`` reads a ``MapArena`` of either package (they name their
arrays alike) into a dict of copies under the keys a checkpoint uses;
``arena_from_numpy`` builds the port's ``MapArena`` from such a dict. The
checkpoint file itself is common to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from sdvo_tpu_torch.align.image_alignment import AlignFeatures
from sdvo_tpu_torch.depth.filter import FilterBank
from sdvo_tpu_torch.device import resolve_device
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.mapping.arena import ARENA_KEYS, MapArena
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


def arena_to_numpy(arena) -> dict:
    """The arrays of a ``MapArena`` (the port's or the reference's) as a dict
    of numpy copies, keyed as in a checkpoint."""
    return {k: np.array(getattr(arena, k)) for k in ARENA_KEYS}


def arena_from_numpy(arrays: dict) -> MapArena:
    """The port's ``MapArena`` holding copies of ``arrays`` (capacities from
    their shapes; the keyframe pyramids stay empty)."""
    K, F, P2 = arrays["feat_patch"].shape
    arena = MapArena(max_keyframes=K, max_points=arrays["pt_valid"].shape[0],
                     max_features_per_kf=F, align_patch_size=int(round(P2 ** 0.5)))
    for k in ARENA_KEYS:
        setattr(arena, k, int(arrays[k]) if k == "kf_counter" else np.array(arrays[k]))
    return arena
