"""Patch sampling at sub-pixel centres — port of the samplers of
``sdvo_tpu.image.stack`` (``sample_patches``, ``sample_patches_grad``,
``sample_patches_multi``, ``sample_patches_grad_multi``).

The JAX module samples from a ``PatchStack`` of P² shifted copies of the
image, a TPU workaround whose own docstring says its results are the
element-gather formulation's. Here each sampler takes the image, or a
(K, H, W) stack with ``host_idx``, and gathers the pixels directly, the
stack addressed as one flat array. What the JAX samplers define is kept:

- the patch's top-left pixel is ``floor(centre) − P//2``, and one weight
  pair ``(wx, wy)``, the centre's fraction, serves the whole patch;
- the gradients are central differences of the bilinear blends at ±1 px;
- ``ok`` says the patch plus a margin lies inside the image: 1 px for the
  values, 2 px with the gradients.

``interp.padded_patch_and_gradients`` takes each pixel's own fraction of
``centre + offset``, which float rounding moves by up to half an ulp of the
coordinate, so its values differ from these by up to 1e-3 on a [0, 255]
image; the blend itself is ``interp.blend``. Where ``ok`` is false the
values are finite (indices are clamped) and callers mask them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sdvo_tpu_torch.image.interp import blend


def _corner(images: torch.Tensor, host_idx, centers: torch.Tensor, patch_size: int):
    """Flat index of each patch's top-left pixel in ``images`` (K, H, W) or
    (H, W), its weights ``(wx, wy)`` (N, 1) and its corner (x0, y0)."""
    H, W = images.shape[-2:]
    half = patch_size // 2
    x0f = torch.floor(centers[:, 0])
    y0f = torch.floor(centers[:, 1])
    wx = (centers[:, 0] - x0f).to(images.dtype)[:, None]
    wy = (centers[:, 1] - y0f).to(images.dtype)[:, None]
    x0 = x0f.to(torch.int64) - half
    y0 = y0f.to(torch.int64) - half
    base = y0 * W + x0
    if host_idx is not None:
        base = base + torch.as_tensor(host_idx, device=centers.device).reshape(-1).to(torch.int64) * (H * W)
    return base, wx, wy, x0, y0


def _grid(images: torch.Tensor, base: torch.Tensor, patch_size: int, wx, wy) -> torch.Tensor:
    """(N, P²) blends of the P×P pixels from top-left ``base`` (N,)."""
    W = images.shape[-1]
    r = torch.arange(patch_size, device=base.device)
    offs = (r[:, None] * W + r[None, :]).reshape(-1)
    flat = images.reshape(-1)
    idx = torch.clamp(base[:, None] + offs[None, :], 0, flat.numel() - W - 2)
    return blend(flat, idx, W, wx, wy)


def _inside(x0, y0, patch_size: int, height: int, width: int, margin: int) -> torch.Tensor:
    """The patch plus ``margin`` px of support inside the image."""
    return ((x0 - margin >= 0) & (y0 - margin >= 0)
            & (x0 + patch_size + margin <= width) & (y0 + patch_size + margin <= height))


def sample_patches_multi(images: torch.Tensor, host_idx, centers: torch.Tensor, patch_size: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear P×P patches at ``centers`` (..., 2) = (x, y), each on image
    ``host_idx[...]`` of ``images`` (K, H, W) (``None``: an (H, W) image).
    Returns (vals (..., P²), ok (...,))."""
    shape = centers.shape[:-1]
    base, wx, wy, x0, y0 = _corner(images, host_idx, centers.reshape(-1, 2), patch_size)
    vals = _grid(images, base, patch_size, wx, wy)
    ok = _inside(x0, y0, patch_size, images.shape[-2], images.shape[-1], 1)
    return vals.reshape(*shape, patch_size * patch_size), ok.reshape(shape)


def sample_patches(image: torch.Tensor, centers: torch.Tensor, patch_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear P×P patches of ``image`` (H, W) at ``centers`` (..., 2).
    Returns (vals (..., P²), ok (...,))."""
    return sample_patches_multi(image, None, centers, patch_size)


def sample_patches_grad_multi(images: torch.Tensor, host_idx, centers: torch.Tensor, patch_size: int):
    """Patches and their central-difference gradients at ``centers``
    (..., 2), each on image ``host_idx[...]`` of ``images`` (K, H, W)
    (``None``: an (H, W) image). Returns (patch, gx, gy, ok), each
    (..., P²) / (...,)."""
    shape = centers.shape[:-1]
    W = images.shape[-1]
    base, wx, wy, x0, y0 = _corner(images, host_idx, centers.reshape(-1, 2), patch_size)
    patch = _grid(images, base, patch_size, wx, wy)
    gx = 0.5 * (_grid(images, base + 1, patch_size, wx, wy) - _grid(images, base - 1, patch_size, wx, wy))
    gy = 0.5 * (_grid(images, base + W, patch_size, wx, wy) - _grid(images, base - W, patch_size, wx, wy))
    ok = _inside(x0, y0, patch_size, images.shape[-2], W, 2)
    P2 = patch_size * patch_size
    return (patch.reshape(*shape, P2), gx.reshape(*shape, P2), gy.reshape(*shape, P2),
            ok.reshape(shape))


def sample_patches_grad(image: torch.Tensor, centers: torch.Tensor, patch_size: int):
    """Patches and gradients of ``image`` (H, W) at ``centers`` (..., 2).
    Returns (patch, gx, gy, ok)."""
    return sample_patches_grad_multi(image, None, centers, patch_size)
