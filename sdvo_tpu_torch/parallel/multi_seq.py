"""Full-System data parallelism: N independent sequences, one batched
superstep — port of ``sdvo_tpu.parallel.multi_seq``.

BASELINE config 4 asks for "8 parallel KITTI sequences, shared kernels,
per-chip maps". ``pipeline.device_system`` carries the whole steady-state VO
loop in a ``VOState`` of fixed-shape tensors with no host read, so
``torch.func.vmap(DeviceVO.superstep)`` runs it over a leading ``seq`` axis:
every op of the superstep takes the S sequences at once, and each of the
four kernels (an operator with a vmap rule) is one launch for all of them.
With a mesh, the sequences split into contiguous groups, each one batched
program on its ``seq`` device, with no communication (each sequence owns its
map). On the card a group's chunk runs as a CUDA graph of the vmapped
supersteps (``pipeline.cuda_graph``), the counterpart of the reference's
jitted scan. This file holds what surrounds that vmap: state stacking, the
chunk function and the lockstep runner.
"""

from __future__ import annotations

import contextlib
import re
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sdvo_tpu_torch.device import deterministic_on, resolve_device
from sdvo_tpu_torch.parallel.mesh import SeqShards, VOMesh, seq_groups, tree_map
from sdvo_tpu_torch.pipeline.cuda_graph import GraphedCall
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem, DeviceVO, FrameOut, VOState


def stack_states(states: Sequence[VOState]) -> VOState:
    """Stack per-sequence VOStates along a new leading ``seq`` axis."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


def unstack_states(state: VOState, n: int) -> List[VOState]:
    return [tree_map(lambda x: x[i], state) for i in range(n)]


@contextlib.contextmanager
def cusolver_linalg(device: torch.device):
    """cuSOLVER for the linear algebra of the block on a CUDA ``device``
    (nothing elsewhere). Under ``torch.func.vmap`` the bundle adjustment's
    ``cholesky_solve`` is batched, and PyTorch's default sends a batched
    solve to MAGMA, whose ``magma_spotrs_batched`` allocates device memory
    with ``cudaMalloc``: a CUDA graph cannot capture that. One sequence's
    solve (a batch of one) goes to cuSOLVER by default."""
    if device.type != "cuda":
        yield
        return
    was = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(was)


def multi_chunk_fn(vo: DeviceVO, mesh: Optional[VOMesh] = None):
    """``(stacked VOState, images (C, S, per, H, W)) → (state, outs)``, a
    loop over the chunk's supersteps (as ``DeviceVO.run_chunk``) of
    ``torch.func.vmap(vo.superstep)``. ``outs`` is a FrameOut with leading
    dims (C, S, per). On the card each group's chunk is a replay of a CUDA
    graph of ``fn.graph``, captured once per card and shapes, and the state
    and outputs are fresh tensors. ``fn.eager`` is the same function
    as the Python loop on any device. Either way the linear algebra runs on
    cuSOLVER on the card (``cusolver_linalg``). With a mesh, ``fn.place(tree,
    images=False)`` cuts a stacked state (``images=True``: the images, along
    their axis 1) over the 'seq' devices; given such ``SeqShards`` the
    function runs each group on its device and returns ``SeqShards`` of
    states and of outputs."""
    superstep = torch.func.vmap(vo.superstep)

    def eager(state: VOState, images: torch.Tensor):
        outs = []
        with cusolver_linalg(images.device):
            for c in range(images.shape[0]):
                state, out = superstep(state, images[c])
                outs.append(out)
        return state, FrameOut(*[torch.stack(x) for x in zip(*outs)])

    graph = GraphedCall(eager, "multi_chunk")

    def graphed(state: VOState, images: torch.Tensor):
        return graph(state, images) if images.device.type == "cuda" else eager(state, images)

    def runner(one):
        def run(state, images):
            if not isinstance(state, SeqShards):
                return one(state, images)
            done = [one(s, im) for s, im in zip(state, images)]
            return SeqShards([d[0] for d in done], 0), SeqShards([d[1] for d in done], 1)

        if mesh is not None:
            def place(tree, images=False):
                n = tree.shape[1] if images else tree.frame_id.shape[0]
                return SeqShards.split(tree, mesh, n, axis=1 if images else 0)

            run.place = place  # type: ignore[attr-defined]
        return run

    run = runner(graphed)
    run.eager = runner(eager)  # type: ignore[attr-defined]
    run.graph = graph  # type: ignore[attr-defined]
    return run


_FALLBACK = re.compile(r"batching rule for (\S+?)\.")


@contextlib.contextmanager
def vmap_fallbacks():
    """Records the ops for which ``torch.func.vmap`` had no batching rule and
    looped over the batch instead (PyTorch's "performance drop" warning)
    inside the block: yields a ``set`` of op names such as ``aten::histc``.
    Other warnings of the block are passed on, each message once."""
    found = set()
    was = torch._C._debug_only_are_vmap_fallback_warnings_enabled()
    torch._C._debug_only_display_vmap_fallback_warnings(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield found
        others = {}
        for w in caught:
            m = _FALLBACK.search(str(w.message))
            if m:
                found.add(m.group(1))
            else:
                others.setdefault(str(w.message), w)
        for w in others.values():
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    finally:
        torch._C._debug_only_display_vmap_fallback_warnings(was)


class MultiSequenceSystem:
    """Lockstep batch VO over N sequences with per-sequence maps.

    Each sequence bootstraps on the host (two-view init, like the single-
    sequence ``DeviceSystem``); the steady state of all sequences then runs as
    one batched chunk a device (per group of a mesh). Sequences may bootstrap
    at different frame indices: the joint phase starts each at its own
    post-bootstrap frame. A sequence whose tracking fails mid-chunk freezes
    (``VOState.failed``) and its frames report failed; it relocalizes on the
    host in the tail phase, through its own ``DeviceSystem``.

    ``device`` defaults to the CUDA card and raises where there is none
    (``device="cpu"`` asks for the CPU); a mesh puts each group of sequences
    on its ``seq`` device instead. On the card the joint chunks run with
    PyTorch's deterministic algorithms (``device.deterministic_on``):
    the bundle adjustment's float ``index_add`` would otherwise sum by
    atomic adds in whatever order the threads reach them, and a sequence
    would not get the same bits from one run to the next. ``chunk_fn`` is
    the joint chunk (``multi_chunk_fn``): on the card a replay of a CUDA graph
    a group (``chunk_fn.graph``). ``ransac_uniforms``: one array (or None)
    per sequence, for the host bootstrap. ``ds_kwargs`` go to every
    ``DeviceSystem``.
    """

    def __init__(self, config, n_seq: int, camera=None, supersteps_per_chunk: int = 8,
                 mesh: Optional[VOMesh] = None, device=None,
                 ransac_uniforms: Optional[Sequence[Optional[np.ndarray]]] = None, **ds_kwargs):
        self.n_seq = n_seq
        self.mesh = mesh
        if mesh is None:
            self.groups = seq_groups(None, n_seq, resolve_device(device))
        else:
            self.groups = seq_groups(mesh, n_seq)
        uniforms = list(ransac_uniforms) if ransac_uniforms is not None else [None] * n_seq
        if len(uniforms) != n_seq:
            raise ValueError(f"{len(uniforms)} RANSAC draws for {n_seq} sequences")
        self.subs = [
            DeviceSystem(config, camera=camera, seed=i, supersteps_per_chunk=supersteps_per_chunk,
                         device=dev, ransac_uniforms=uniforms[i], **ds_kwargs)
            for dev, members in self.groups for i in members
        ]
        self.supersteps_per_chunk = supersteps_per_chunk
        self.vo = self.subs[0].vo  # shared kernels: one program for every sequence
        self.chunk_fn = multi_chunk_fn(self.vo, mesh)

    @property
    def period(self) -> int:
        return self.subs[0].scfg.period

    def run(self, sequences: List[List[np.ndarray]]) -> List[Dict]:
        """Process N sequences to completion: ``bootstrap``, ``joint``,
        ``tail``. Returns per-sequence dicts with ``trajectory`` (list of 4×4
        or None) and ``metrics``."""
        self.bootstrap(sequences)
        self.joint(sequences)
        return self.tail(sequences)

    def bootstrap(self, sequences: List[List[np.ndarray]]):
        """Phase 1: the host bootstrap of every sequence, frame by frame until
        its state is on its device."""
        if len(sequences) != self.n_seq:
            raise ValueError(f"{len(sequences)} sequences for {self.n_seq}")
        self._ptr = [0] * self.n_seq
        for i, (sub, seq) in enumerate(zip(self.subs, sequences)):
            while sub.state is None and self._ptr[i] < len(seq):
                sub.add_image(np.asarray(seq[self._ptr[i]]), float(self._ptr[i]))
                self._ptr[i] += 1
            if sub.state is None:
                raise RuntimeError(f"sequence {i} failed to bootstrap")
        # the stacked state: one batch a group, on the group's device
        parts = [stack_states([self.subs[i].state for i in members]) for _, members in self.groups]
        self._state = parts[0] if self.mesh is None else SeqShards(parts, 0)

    def joint(self, sequences: List[List[np.ndarray]]):
        """Phase 2: lockstep chunks of ``supersteps_per_chunk`` supersteps, one
        batched program a group, while every sequence has a whole chunk
        left; a second call goes on where the first stopped. ``frame_steps``
        counts the lockstep frame steps of the last call (each one frame of
        every sequence) and ``chunk_seconds`` the host time of each of its
        chunks, up to the chunk's outputs on the host."""
        self.frame_steps, self.chunk_seconds = 0, []
        with deterministic_on(self.groups[0][0]):  # a mesh's groups lie on devices of one type
            self._joint(sequences)

    def _joint(self, sequences: List[List[np.ndarray]]):
        ptr = self._ptr
        per = self.period
        C = self.supersteps_per_chunk
        chunk_frames = C * per
        while all(ptr[i] + chunk_frames <= len(sequences[i]) for i in range(self.n_seq)):
            t0 = time.perf_counter()
            imgs = np.stack([np.stack(sequences[i][ptr[i]:ptr[i] + chunk_frames]).astype(np.float32)
                             for i in range(self.n_seq)])  # (S, C·per, H, W)
            imgs = imgs.reshape(self.n_seq, C, per, *imgs.shape[2:]).transpose(1, 0, 2, 3, 4)
            imgs = torch.from_numpy(np.ascontiguousarray(imgs))  # (C, S, per, H, W)
            imgs = imgs.to(self.groups[0][0]) if self.mesh is None else self.chunk_fn.place(imgs, images=True)
            self._state, outs = self.chunk_fn(self._state, imgs)
            if isinstance(outs, SeqShards):
                outs = outs.gather(torch.device("cpu"))
            outs = FrameOut(*[x.cpu().numpy() for x in outs])
            for i, sub in enumerate(self.subs):
                sub._emit(FrameOut(*[x[:, i] for x in outs]), chunk_frames)
            self.chunk_seconds.append(time.perf_counter() - t0)
            self.frame_steps += chunk_frames
            for i in range(self.n_seq):
                ptr[i] += chunk_frames

    def tail(self, sequences: List[List[np.ndarray]]) -> List[Dict]:
        """Phase 3: each sequence's remaining frames through its own
        ``DeviceSystem``, after ``_relocalize`` where it failed."""
        results = []
        parts = self._state if isinstance(self._state, SeqShards) else [self._state]
        for (_, members), part in zip(self.groups, parts):
            for i, final in zip(members, unstack_states(part, len(members))):
                sub = self.subs[i]
                sub.state = final
                if bool(final.failed):
                    sub._relocalize()
                for j in range(self._ptr[i], len(sequences[i])):
                    sub.add_image(np.asarray(sequences[i][j]), float(j))
                sub.finish()
                results.append({"trajectory": sub.trajectory, "metrics": sub.metrics})
        return results
