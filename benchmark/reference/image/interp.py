"""Bilinear sampling and patch extraction — port of ``sdvo_tpu.image.interp``."""

from __future__ import annotations

import torch


def bilinear_sample(image: torch.Tensor, uv: torch.Tensor, clamp: bool = True):
    """Sample ``image`` (H, W) at ``uv`` (..., 2) = (x, y). Returns (values,
    valid) with valid = the 2×2 support inside the image; the weights take
    the image dtype, as the reference. Corner indices are clamped; with
    ``clamp=False`` the corners are taken where they fall in the flattened
    image, by ``jnp.take``'s rule: a flat index in [−H·W, 0) counts from the
    end, any other outside [0, H·W) gives NaN. Nothing is read outside the
    image either way."""
    H, W = image.shape
    x0f = torch.floor(uv[..., 0])
    y0f = torch.floor(uv[..., 1])
    wx = (uv[..., 0] - x0f).to(image.dtype)
    wy = (uv[..., 1] - y0f).to(image.dtype)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    valid = (x0 >= 0) & (y0 >= 0) & (x0 + 1 <= W - 1) & (y0 + 1 <= H - 1)
    flat = image.reshape(-1)
    if clamp:
        return blend(flat, torch.clamp(y0, 0, H - 2) * W + torch.clamp(x0, 0, W - 2), W, wx, wy), valid
    base = y0 * W + x0
    n = H * W

    def take(idx):
        inside = (idx >= -n) & (idx < n)
        v = flat[torch.where(inside, torch.remainder(idx, n), torch.zeros_like(idx))]
        return torch.where(inside, v, torch.full_like(v, float("nan")))

    return blend_values(take(base), take(base + 1), take(base + W), take(base + W + 1), wx, wy), valid


def blend(flat: torch.Tensor, base: torch.Tensor, W: int, wx: torch.Tensor, wy: torch.Tensor):
    """The bilinear blend of the pixels at flat indices ``base``, ``base+1``,
    ``base+W`` and ``base+W+1`` of an image of width ``W`` with weights
    ``(wx, wy)`` (broadcasting against ``base``)."""
    return blend_values(flat[base], flat[base + 1], flat[base + W], flat[base + W + 1], wx, wy)


def blend_values(v00, v01, v10, v11, wx: torch.Tensor, wy: torch.Tensor):
    """The bilinear blend of the four corner values with weights ``(wx, wy)``."""
    return v00 * ((1.0 - wx) * (1.0 - wy)) + v01 * (wx * (1.0 - wy)) \
        + v10 * ((1.0 - wx) * wy) + v11 * (wx * wy)


def patch_offsets(patch_size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(P², 2) offsets (dx, dy) centred on the patch, row-major (dy outer)."""
    half = patch_size // 2
    r = torch.arange(-half, patch_size - half, dtype=dtype, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)


def padded_patch_and_gradients(sample_fn, centers: torch.Tensor, patch_size: int):
    """One (P+2)² bilinear patch per feature through ``sample_fn`` (uv
    (N, (P+2)², 2) → (values (N, (P+2)²), ok), e.g. a closure over
    ``bilinear_sample(image, ·)``); returns the P² patch, its central-difference
    gradients and the all-inside flag."""
    P = patch_size
    K = P + 2
    offs = patch_offsets(K, dtype=centers.dtype, device=centers.device)
    vals, ok = sample_fn(centers[:, None, :] + offs[None])
    N = vals.shape[0]
    big = vals.reshape(N, K, K)
    patch = big[:, 1:-1, 1:-1]
    gx = 0.5 * (big[:, 1:-1, 2:] - big[:, 1:-1, :-2])
    gy = 0.5 * (big[:, 2:, 1:-1] - big[:, :-2, 1:-1])
    return patch.reshape(N, -1), gx.reshape(N, -1), gy.reshape(N, -1), ok.all(dim=-1)


