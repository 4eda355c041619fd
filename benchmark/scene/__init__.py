"""The benchmark's scene: bench.py's ridge under its periodic camera path, at
KITTI geometry, rendered on the card.

A ridge of two textured planes (z = 12 m for world x < −1.5, z = 18 m
elsewhere) under ``smooth_texture(size=4096, blur=13)``, seen by the KITTI
camera 0 (1241×376, fx = fy = 721.5377). The world→camera pose of frame i
is exp of the twist ``twist(i)``, sines of period 36, 18, 48 and 30 frames,
so the path repeats every ``PERIOD`` = 720 frames; frame 1 alone takes the
bootstrap's lateral baseline of 0.15 m. So 721 renders serve a stream of any
length: ``ring_index(i)`` is the row of frame i.

The renderer (``render``) is PyTorch in float64 and runs on the card or, for
the CPU rehearsal and the tests, on the CPU; ``render_np`` is the same
formula in numpy (bench.py's ``render_ridge`` without supersampling). The
texture is drawn on the host from the seed exactly as ``smooth_texture``
draws it and blurred on the device (``blur_wrap``: scipy's Gaussian kernel,
wrapped). Frames are handed to the program as 8-bit grayscale, rounded.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np

PERIOD = 720  # the least common multiple of 36, 18, 48 and 30 frames
BOOT_LATERAL = 0.15  # frame 1's lateral baseline for the two-view bootstrap
KITTI_CAMERA = dict(fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854, width=1241, height=376)
TEXTURE_SIZE = 4096
TEXTURE_BLUR = 13
Z_NEAR, Z_FAR, SPLIT_X, TEX_SCALE = 12.0, 18.0, -1.5, 40.0


def twist(i: int) -> np.ndarray:
    """The twist (v, w) of frame ``i``'s world→camera pose."""
    lat = BOOT_LATERAL if i == 1 else 0.30 * np.sin(2.0 * np.pi * i / 36.0)
    return np.asarray([
        lat, 0.03 * np.sin(4.0 * np.pi * i / 36.0), 0.18 * np.sin(2.0 * np.pi * i / 48.0),
        0.002 * np.sin(2.0 * np.pi * i / 36.0), 0.005 * np.sin(2.0 * np.pi * i / 30.0), 0.0,
    ])


def se3_exp(tau) -> np.ndarray:
    """exp of the twist (v, w) as a 4×4 matrix."""
    from scipy.linalg import expm

    xi = np.zeros((4, 4))
    xi[:3, :3] = [[0, -tau[5], tau[4]], [tau[5], 0, -tau[3]], [-tau[4], tau[3], 0]]
    xi[:3, 3] = tau[:3]
    return expm(xi)


def ring_index(i: int) -> int:
    """The ring's row of stream frame ``i``: row ``PERIOD`` holds frame 1's
    bootstrap form, rows 0 … 719 the path's frames modulo ``PERIOD``."""
    return PERIOD if i == 1 else i % PERIOD


def ring_poses() -> np.ndarray:
    """(721, 4, 4) world→camera poses of the ring's rows."""
    rows = [se3_exp(twist(k)) if k != 1 else se3_exp(twist(PERIOD + 1)) for k in range(PERIOD)]
    rows.append(se3_exp(twist(1)))
    return np.stack(rows)


def texture_draw(seed: int, size: int = TEXTURE_SIZE) -> np.ndarray:
    """The uniform draw of ``smooth_texture``: ``default_rng(seed)``'s
    (size, size) floats in [0, 255)."""
    return np.random.default_rng(seed).uniform(0.0, 255.0, size=(size, size))


def gaussian_weights(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy's ``gaussian_filter1d`` weights (radius int(truncate·σ + 0.5))."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    w = np.exp(-0.5 / (sigma * sigma) * x * x)
    return w / w.sum()


def blur_wrap(tex, sigma: float):
    """``scipy.ndimage.gaussian_filter(tex, sigma, mode="wrap")`` of a 2-D
    float64 tensor, one axis after the other."""
    import torch

    w = gaussian_weights(sigma)
    r = len(w) // 2
    for dim in (0, 1):
        out = torch.zeros_like(tex)
        for j, wj in enumerate(w):
            out += float(wj) * torch.roll(tex, shifts=r - j, dims=dim)
        tex = out
    return tex


def smooth_texture(seed: int, device, size: int = TEXTURE_SIZE, blur: int = TEXTURE_BLUR):
    """``smooth_texture(default_rng(seed), size, blur)`` as a float64 tensor
    on ``device``: drawn on the host, blurred and renormalised to [0, 255]
    on the device."""
    import torch

    tex = blur_wrap(torch.from_numpy(texture_draw(seed, size)).to(device), blur / 3.0)
    lo, hi = tex.min(), tex.max()
    return (tex - lo) / (hi - lo) * 255.0


def camera(scale: float = 1.0) -> SimpleNamespace:
    """The KITTI camera, or a copy ``scale`` times its size (the CPU
    rehearsal's)."""
    c = dict(KITTI_CAMERA)
    if scale != 1.0:
        c = dict(fx=c["fx"] * scale, fy=c["fy"] * scale, cx=c["cx"] * scale, cy=c["cy"] * scale,
                 width=int(round(c["width"] * scale)), height=int(round(c["height"] * scale)))
    return SimpleNamespace(**c)


def render(tex, T, cam):
    """The ridge under ``tex`` (float64 (S, S) tensor) seen from the
    world→camera poses ``T`` ((B, 4, 4) float64 tensor on ``tex``'s
    device): (B, H, W) float64 in [0, 255]."""
    import torch

    dev, f64 = tex.device, torch.float64
    H, W = cam.height, cam.width
    vv, uu = torch.meshgrid(torch.arange(H, dtype=f64, device=dev), torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    x = (uu.reshape(-1) - cam.cx) / cam.fx
    y = (vv.reshape(-1) - cam.cy) / cam.fy
    b = torch.stack([x, y, torch.ones_like(x)], -1)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    R, t = T[:, :3, :3], T[:, :3, 3]
    C = -(R.transpose(1, 2) @ t[..., None])[..., 0]  # (B, 3) camera centres in the world
    dirs = b[None] @ R  # (B, N, 3): Rᵀ b a row
    lam_near = (Z_NEAR - C[:, None, 2]) / dirs[..., 2]
    lam_far = (Z_FAR - C[:, None, 2]) / dirs[..., 2]
    p_near = C[:, None] + lam_near[..., None] * dirs
    p_far = C[:, None] + lam_far[..., None] * dirs
    pts = torch.where((p_near[..., 0] < SPLIT_X)[..., None], p_near, p_far)
    c = tex.shape[0] / 2.0
    u = torch.clamp(pts[..., 0] * TEX_SCALE + c, 0.0, tex.shape[1] - 1.001)
    v = torch.clamp(pts[..., 1] * TEX_SCALE + c, 0.0, tex.shape[0] - 1.001)
    x0, y0 = torch.floor(u), torch.floor(v)
    wx, wy = u - x0, v - y0
    x0, y0 = x0.long(), y0.long()
    Wt = tex.shape[1]
    flat = tex.reshape(-1)

    def at(yy, xx):
        return flat[yy * Wt + xx]

    img = ((at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx) * (1 - wy)
           + (at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx) * wy)
    return img.reshape(-1, H, W)


def render_np(tex: np.ndarray, T: np.ndarray, cam) -> np.ndarray:
    """``render`` in numpy for one pose: bench.py's ``render_ridge`` at
    12/18 m split at x = −1.5, without supersampling."""
    H, W = cam.height, cam.width
    vv, uu = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    x = (uu.ravel() - cam.cx) / cam.fx
    y = (vv.ravel() - cam.cy) / cam.fy
    b = np.stack([x, y, np.ones_like(x)], axis=-1)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    R, t = T[:3, :3], T[:3, 3]
    C = -R.T @ t
    dirs = b @ R
    p_near = C[None] + ((Z_NEAR - C[2]) / dirs[:, 2])[:, None] * dirs
    p_far = C[None] + ((Z_FAR - C[2]) / dirs[:, 2])[:, None] * dirs
    pts = np.where((p_near[:, 0] < SPLIT_X)[:, None], p_near, p_far)
    c = tex.shape[0] / 2.0
    u = np.clip(pts[:, 0] * TEX_SCALE + c, 0.0, tex.shape[1] - 1.001)
    v = np.clip(pts[:, 1] * TEX_SCALE + c, 0.0, tex.shape[0] - 1.001)
    x0, y0 = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    wx, wy = u - x0, v - y0
    img = ((tex[y0, x0] * (1 - wx) + tex[y0, x0 + 1] * wx) * (1 - wy)
           + (tex[y0 + 1, x0] * (1 - wx) + tex[y0 + 1, x0 + 1] * wx) * wy)
    return img.reshape(H, W)


def to_u8(img):
    """Float frames in [0, 255] as 8-bit grayscale, rounded to nearest."""
    import torch

    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


class Ring:
    """A stream's frames: ``frames`` (721, H, W) uint8 on the host, the ring
    of ``ring_index``; ``poses`` (721, 4, 4) its world→camera truth.
    ``frame(i)`` and ``truth(i)`` are stream frame i's."""

    def __init__(self, frames: np.ndarray, poses: np.ndarray):
        self.frames = frames
        self.poses = poses

    def frame(self, i: int) -> np.ndarray:
        return self.frames[ring_index(i)]

    def truth(self, i: int) -> np.ndarray:
        return self.poses[ring_index(i)]


def build_ring(seed: int, device, cam=None, texture_size: int = TEXTURE_SIZE, batch: int = 48,
               poses: Optional[np.ndarray] = None) -> Ring:
    """The ring of texture ``seed``: drawn, blurred and rendered on
    ``device`` in batches of ``batch`` frames, each batch copied to the host
    as 8-bit frames."""
    import torch

    cam = cam or camera()
    poses = ring_poses() if poses is None else poses
    tex = smooth_texture(seed, device, texture_size)
    T = torch.from_numpy(poses).to(device)
    out = np.empty((len(poses), cam.height, cam.width), np.uint8)
    for lo in range(0, len(poses), batch):
        out[lo:lo + batch] = to_u8(render(tex, T[lo:lo + batch], cam)).cpu().numpy()
    del tex
    return Ring(out, poses)
