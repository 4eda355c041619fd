"""Data-parallel sparse image alignment over sequences — port of
``sdvo_tpu.parallel.batched_vo``.

``SparseImageAlign.align`` has fixed shapes and no host read, so
``torch.func.vmap`` batches it over a leading ``seq`` axis; K1 inside it is an
operator whose vmap rule solves the whole batch in one launch a level on the
card. With a mesh, each group of sequences runs on its ``seq`` device.
"""

from __future__ import annotations

import torch

from sdvo_tpu_torch.align.image_alignment import SparseImageAlign
from sdvo_tpu_torch.parallel.mesh import SeqShards, VOMesh


def batched_align_step(aligner: SparseImageAlign, mesh: VOMesh, num_levels: int):
    """Build a batched alignment step.

    Returns ``step(T_init (S,), host_pyrs, cur_pyrs, feats, fx, fy, cx, cy)``
    → ``(T (S,), rmse (S,), status (S,))``, where every tensor argument
    carries a leading sequence axis S. ``host_pyrs``/``cur_pyrs`` are tuples
    of ``num_levels`` per-level image stacks: host (S, n_hosts, H_l, W_l),
    cur (S, H_l, W_l). ``step.place(tree)`` cuts a tree over the mesh's
    'seq' devices (``SeqShards``); the step runs each group on its device
    and returns the results joined on the first.
    """

    batched = torch.func.vmap(aligner.align, in_dims=(0, 0, 0, 0, None, None, None, None))

    def step(T_init, host_pyrs, cur_pyrs, feats, fx, fy, cx, cy):
        trees = (T_init, host_pyrs, cur_pyrs, feats)
        if not isinstance(T_init, SeqShards):  # not placed yet
            trees = tuple(place(t) for t in trees)
        groups = list(zip(*trees))
        if len(groups[0][2]) != num_levels:
            raise ValueError(f"{len(groups[0][2])} pyramid levels, the step was built for {num_levels}")
        return SeqShards([batched(*g, fx, fy, cx, cy) for g in groups]).gather()

    def place(tree) -> SeqShards:
        return SeqShards.split(tree, mesh, _seq_len(tree))

    step.place = place  # type: ignore[attr-defined]
    return step


def _seq_len(tree) -> int:
    """The length of the leading (sequence) axis of a tree's first tensor."""
    return tree.shape[0] if isinstance(tree, torch.Tensor) else _seq_len(tree[0])
