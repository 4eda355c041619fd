"""Bilinear sampling and patch extraction — port of ``sdvo_tpu.image.interp``."""

from __future__ import annotations

import torch


def bilinear_sample(image: torch.Tensor, uv: torch.Tensor):
    """Sample ``image`` (H, W) at ``uv`` (..., 2) = (x, y). Returns (values,
    valid) with valid = the 2×2 support inside the image. Corner indices are
    clamped; the weights take the image dtype, as the reference."""
    H, W = image.shape
    x0f = torch.floor(uv[..., 0])
    y0f = torch.floor(uv[..., 1])
    wx = (uv[..., 0] - x0f).to(image.dtype)
    wy = (uv[..., 1] - y0f).to(image.dtype)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    valid = (x0 >= 0) & (y0 >= 0) & (x0 + 1 <= W - 1) & (y0 + 1 <= H - 1)
    base = torch.clamp(y0, 0, H - 2) * W + torch.clamp(x0, 0, W - 2)
    flat = image.reshape(-1)
    v00, v01 = flat[base], flat[base + 1]
    v10, v11 = flat[base + W], flat[base + W + 1]
    out = v00 * ((1.0 - wx) * (1.0 - wy)) + v01 * (wx * (1.0 - wy)) \
        + v10 * ((1.0 - wx) * wy) + v11 * (wx * wy)
    return out, valid


def patch_offsets(patch_size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(P², 2) offsets (dx, dy) centred on the patch, row-major (dy outer)."""
    half = patch_size // 2
    r = torch.arange(-half, patch_size - half, dtype=dtype, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)


def padded_patch_and_gradients(image: torch.Tensor, centers: torch.Tensor, patch_size: int):
    """One (P+2)² bilinear patch per feature on ``image``; returns the P² patch,
    its central-difference gradients and the all-inside flag."""
    P = patch_size
    K = P + 2
    offs = patch_offsets(K, dtype=centers.dtype, device=centers.device)
    vals, ok = bilinear_sample(image, centers[:, None, :] + offs[None])
    N = vals.shape[0]
    big = vals.reshape(N, K, K)
    patch = big[:, 1:-1, 1:-1]
    gx = 0.5 * (big[:, 1:-1, 2:] - big[:, 1:-1, :-2])
    gy = 0.5 * (big[:, 2:, 1:-1] - big[:, :-2, 1:-1])
    return patch.reshape(N, -1), gx.reshape(N, -1), gy.reshape(N, -1), ok.all(dim=-1)


def extract_patches(image: torch.Tensor, centers: torch.Tensor, patch_size: int):
    """(N, P²) bilinear patches around ``centers`` and the all-inside flag."""
    offs = patch_offsets(patch_size, dtype=centers.dtype, device=centers.device)
    vals, ok = bilinear_sample(image, centers[:, None, :] + offs[None])
    return vals, ok.all(dim=-1)
