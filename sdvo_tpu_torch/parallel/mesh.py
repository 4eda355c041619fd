"""The devices of the VO parallelism axes — port of ``sdvo_tpu.parallel.mesh``.

The JAX package scales out over two named mesh axes:

* ``seq``  — data parallel over independent video sequences (one map per
  sequence, shared kernels; BASELINE config 4), and
* ``shard`` — landmark-block sharding of bundle adjustment (BASELINE
  config 5).

PyTorch has no mesh: ``VOMesh`` holds the same (num_seq, num_shard) grid of
``torch.device``s, and ``SeqShards`` stands in for ``NamedSharding(P("seq"))``.
A tree of tensors with a sequence axis is cut into contiguous groups, group g
on the g-th ``seq`` device (column 0 of the grid); each group is processed by
its own batched program on its device, with no communication between groups.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class VOMesh(NamedTuple):
    devices: np.ndarray  # (num_seq, num_shard) of torch.device
    axis_names: Tuple[str, str] = ("seq", "shard")

    @property
    def seq_devices(self) -> List[torch.device]:
        return list(self.devices[:, 0])


def make_vo_mesh(num_seq: Optional[int] = None, num_shard: int = 1,
                 devices: Optional[Sequence] = None) -> VOMesh:
    """Mesh with axes ('seq', 'shard'). Defaults: every CUDA card, all on
    'seq'. Raises without a card unless ``devices`` are given (for example
    ``["cpu"] * 2``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: make_vo_mesh takes every card by default; pass '
                               'devices (e.g. ["cpu"] * 2) to build a mesh elsewhere')
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if num_seq is None:
        num_seq = n // num_shard
    if num_seq * num_shard != n:
        raise ValueError(f"{num_seq}x{num_shard} != {n} devices")
    grid = np.empty((num_seq, num_shard), dtype=object)
    for i, d in enumerate(devices):
        grid[i // num_shard, i % num_shard] = d
    return VOMesh(grid)


def seq_groups(mesh: Optional[VOMesh], n: int, device=None) -> List[Tuple[torch.device, range]]:
    """The contiguous groups of ``n`` sequences, one per ``seq`` device (sizes
    differ by at most one; a device with none is left out). Without a mesh,
    one group on ``device``."""
    if mesh is None:
        return [(torch.device(device) if device is not None else None, range(n))]
    parts = np.array_split(np.arange(n), len(mesh.seq_devices))
    return [(d, range(int(p[0]), int(p[-1]) + 1)) for d, p in zip(mesh.seq_devices, parts) if len(p)]


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of matching nested tuples / NamedTuples;
    other leaves are taken from the first tree."""
    a = trees[0]
    if isinstance(a, torch.Tensor):
        return fn(*trees)
    if isinstance(a, (tuple, list)):
        vals = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(a)(*vals) if hasattr(a, "_fields") else type(a)(vals)
    return a


class SeqShards(list):
    """A tree cut along its sequence axis ``axis`` into the groups of
    ``seq_groups``, each on its device: the counterpart of an array sharded
    over the mesh's 'seq' axis. ``gather`` joins them again."""

    def __init__(self, parts, axis: int = 0):
        super().__init__(parts)
        self.axis = axis

    @staticmethod
    def split(tree, mesh: VOMesh, n: int, axis: int = 0) -> "SeqShards":
        def cut(d, r):
            return tree_map(lambda x: x.narrow(axis, r.start, len(r)).to(d or x.device), tree)

        return SeqShards([cut(d, r) for d, r in seq_groups(mesh, n)], axis)

    def gather(self, device=None):
        device = device if device is not None else _first_device(self[0])
        return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs], self.axis), *self)


def _first_device(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device
    return next(_first_device(x) for x in tree if isinstance(x, (torch.Tensor, tuple, list)))
