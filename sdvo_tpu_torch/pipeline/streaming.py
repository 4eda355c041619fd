"""The streaming tracker: F frames a call against one fixed reference
keyframe — port of ``sdvo_tpu.pipeline.streaming``.

Each frame runs the pyramid, the coarse-to-fine sparse alignment against the
reference keyframe's pyramid (K1 a level, ``SparseImageAlign.align``), the
reprojection feature alignment of the matched features at the estimated pose
(K2, ``align_features_2d``) and the depth-filter update against the frame
(K4, ``update_filters``), carrying the pose chain and the filters from frame
to frame. The reference runs the frames as one ``lax.scan``; here they are a
Python loop over the chunk, staged on the device once, that reads nothing
back to the host: fixed shapes, no ``.item()``, so that the chunk can be
captured as a CUDA graph. Keyframe decisions and map bookkeeping stay with
the caller, at chunk boundaries.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sdvo_tpu_torch.align.feature_alignment import align_features_2d
from sdvo_tpu_torch.align.image_alignment import AlignFeatures, SparseImageAlign
from sdvo_tpu_torch.depth.filter import FilterBank, update_filters
from sdvo_tpu_torch.device import deterministic_on, resolve_device
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.pyramid import build_pyramid


class StreamCarry(NamedTuple):
    T_cur_ref: SE3  # pose of the latest tracked frame w.r.t. the reference keyframe
    T_prev_ref: SE3  # pose of the frame before it (the constant-velocity seed)
    filters: FilterBank


class StreamOutputs(NamedTuple):
    rotations: torch.Tensor  # (F, 3, 3) each frame's T_cur_ref rotation
    translations: torch.Tensor  # (F, 3)
    rmse: torch.Tensor  # (F,) alignment rmse of the finest level
    status: torch.Tensor  # (F,) int32 alignment status
    uv_refined: torch.Tensor  # (F, M, 2) feature-alignment output
    fa_converged: torch.Tensor  # (F, M) bool
    df_converged: torch.Tensor  # (F, C) bool depth filters that converged at the frame


def _place(tree, device: torch.device):
    """Every leaf of a tree of NamedTuples and tuples (tensors or arrays) on
    ``device``, dtypes kept."""
    if hasattr(tree, "_fields"):
        return type(tree)(*[_place(x, device) for x in tree])
    if isinstance(tree, (tuple, list)):
        return tuple(_place(x, device) for x in tree)
    return torch.as_tensor(tree, device=device)


class StreamingTracker:
    """Tracks a chunk of frames against a reference keyframe whose pyramid
    and alignment features stay fixed for the chunk, as they do between two
    keyframes of the reference (tracking is always against the last
    keyframe). ``device`` is where the chunk runs: the CUDA card unless the
    caller names another (``"cpu"``)."""

    def __init__(self, aligner: SparseImageAlign, levels: int = 4, fa_patch: int = 5, fa_iters: int = 10,
                 const_velocity: bool = False, device=None):
        # const_velocity=True extrapolates the seed with the last inter-frame
        # delta (the reference's predictionRelativePose). Inside a long chunk
        # this couples with the frozen-ESM Jacobian (which is evaluated AT the
        # seed) into a positive feedback: seed error compounds geometrically
        # across frames. Previous-pose seeding is unconditionally stable for
        # inter-frame motion within the coarse level's basin (~±half a
        # coarse-level patch), so it is the default.
        self.aligner = aligner
        self.levels = int(levels)
        self.fa_patch = int(fa_patch)
        self.fa_iters = int(fa_iters)
        self.const_velocity = bool(const_velocity)
        self.device = resolve_device(device)

    def _frame_step(self, carry: StreamCarry, image: torch.Tensor, host_pyr, host_grad0, feats: AlignFeatures,
                    uv_match, match_valid, fx: float, fy: float, cx: float, cy: float, kf_counter):
        pyr = build_pyramid(image, self.levels)
        if self.const_velocity:  # T_seed = (T_k · T_{k-1}⁻¹) · T_k
            T_seed = carry.T_cur_ref.compose(carry.T_prev_ref.inverse()).compose(carry.T_cur_ref)
        else:
            T_seed = carry.T_cur_ref
        T_est, rmse, status = self.aligner.align(T_seed, host_pyr, pyr.images, feats, fx, fy, cx, cy)

        # the matched features at the estimated pose, refined by feature alignment
        M = uv_match.shape[0]
        p_cur = T_est.apply(feats.points_ref[:M])
        z = torch.where(p_cur[..., 2] < 1e-6, torch.ones_like(p_cur[..., 2]), p_cur[..., 2])
        uv_init = torch.stack([fx * p_cur[..., 0] / z + cx, fy * p_cur[..., 1] / z + cy], dim=-1)
        uv_out, _, fa_conv = align_features_2d(
            host_grad0, pyr.base_gradient, uv_match, uv_init, match_valid, self.fa_patch, self.fa_iters,
            torch.zeros((M,), dtype=torch.int32, device=uv_match.device))

        # the depth filters against this frame (reference keyframe → frame = T_est)
        C = carry.filters.mu.shape[0]
        T_bcast = SE3(T_est.rotation.expand(C, 3, 3), T_est.translation.expand(C, 3))
        bank, df_conv = update_filters(carry.filters, T_bcast, pyr.base_image, fx, fy, cx, cy, kf_counter)

        new_carry = StreamCarry(T_cur_ref=T_est, T_prev_ref=carry.T_cur_ref, filters=bank)
        return new_carry, (T_est.rotation, T_est.translation, rmse, status, uv_out, fa_conv, df_conv)

    def track_chunk(self, images, host_pyr, host_grad0, feats: AlignFeatures, uv_match, match_valid,
                    T_init: SE3, T_prev: SE3, filters: FilterBank, fx, fy, cx, cy, kf_counter
                    ) -> Tuple[StreamCarry, StreamOutputs]:
        """Tracks ``images`` (F, H, W) in order: ``host_pyr`` holds the
        reference keyframe's pyramid, one (n_hosts, H_l, W_l) stack a level,
        ``host_grad0`` its level-0 gradient image, ``feats`` the alignment
        features, ``uv_match``/``match_valid`` (M,) the matched features'
        positions in the keyframe (the first M of ``feats``), ``T_init`` and
        ``T_prev`` the last two poses against the keyframe and ``filters``
        the depth-filter bank. Inputs may be tensors anywhere or numpy
        arrays; they move to the tracker's device once. Returns the carry
        after the last frame and each frame's outputs stacked along F."""
        dev = self.device
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        images = torch.as_tensor(images, device=dev)
        host_pyr, host_grad0, feats, uv_match, match_valid, T_init, T_prev, filters = _place(
            (tuple(host_pyr), host_grad0, feats, uv_match, match_valid, T_init, T_prev, filters), dev)
        kf_counter = torch.as_tensor(kf_counter, dtype=torch.int32, device=dev)
        fx, fy, cx, cy = float(fx), float(fy), float(cx), float(cy)

        carry = StreamCarry(T_cur_ref=T_init, T_prev_ref=T_prev, filters=filters)
        outs = []
        with deterministic_on(dev):
            for f in range(images.shape[0]):
                carry, out = self._frame_step(carry, images[f], host_pyr, host_grad0, feats, uv_match,
                                              match_valid, fx, fy, cx, cy, kf_counter)
                outs.append(out)
        return carry, StreamOutputs(*(torch.stack(column) for column in zip(*outs)))
