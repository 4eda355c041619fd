"""The benchmark's scene: bench.py's ridge under a periodic camera path, seen
by a configuration's camera, rendered on the card.

Everything here is read from a configuration's file: its ``camera`` block
(``camera``) and its ``scene`` block (``Scene.of``). The scene is a ridge of
two textured planes (z = ``z_near_m`` for world x < ``split_x_m``, z =
``z_far_m`` elsewhere) under ``smooth_texture(texture_size, texture_blur)``
laid out at ``texture_px_per_m`` texels a metre. The world→camera pose of
frame i is exp of the twist ``Scene.twist(i)``: on each of its six axes
(v, w) a sine of ``path_amplitudes`` and ``path_periods_frames``, so the path
repeats every ``period_frames`` frames, the least common multiple of the
periods; frame 1 alone takes the bootstrap's lateral baseline
(``bootstrap_lateral_m``). So ``period_frames`` + 1 renders serve a stream of
any length: ``ring_index(i, period_frames)`` is the row of frame i. The
path's keys, the baseline and the texture's scale are optional; their
defaults (``PATH``, ``BOOT_LATERAL``, ``TEX_SCALE``) are bench.py's.

The renderer (``render``) is PyTorch in float64 and runs on the card or, for
the CPU rehearsal and the tests, on the CPU; ``render_np`` is the same
formula in numpy for a camera without distortion (bench.py's
``render_ridge`` without supersampling). A camera with distortion (OpenCV
order k1, k2, p1, p2, k3) sees what that lens sees: each pixel's normalized
coordinates are undistorted by Newton's method in float64 before forming its
ray (``rays``); the truth poses are the same. The texture is drawn on the
host from the seed exactly as ``smooth_texture`` draws it and blurred on the
device (``blur_wrap``: scipy's Gaussian kernel, wrapped). Frames are handed
to the program as 8-bit grayscale, rounded.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np

# the defaults of the scene's optional keys: bench.py's path, baseline and texture scale
PATH = ((0.30, 36), (0.03, 18), (0.18, 48), (0.002, 36), (0.005, 30), (0.0, 1))  # (amplitude, period) of v, w
BOOT_LATERAL = 0.15  # frame 1's lateral baseline for the two-view bootstrap
TEX_SCALE = 40.0  # texels a metre
RENDER_PIXELS = 48 * 1241 * 376  # pixels rendered at once: 48 frames at KITTI size
RENDER_FRAMES = 48  # and at most this many frames
NEWTON_TOL = 1e-12  # the undistortion's largest residual, normalized coordinates
NEWTON_ITERS = 50


@dataclass(frozen=True)
class Scene:
    """A configuration's ``scene`` block: the ridge, the texture and the
    camera path."""

    texture_size: int
    texture_blur: float
    z_near: float
    z_far: float
    split_x: float
    period: int
    amplitudes: Tuple[float, ...] = tuple(a for a, _ in PATH)
    periods: Tuple[int, ...] = tuple(p for _, p in PATH)
    boot_lateral: float = BOOT_LATERAL
    tex_scale: float = TEX_SCALE

    @classmethod
    def of(cls, block: dict) -> "Scene":
        """The scene of a configuration's ``scene`` block; refuses a
        ``period_frames`` that is not the path's period."""
        sc = cls(texture_size=int(block["texture_size"]), texture_blur=block["texture_blur"],
                 z_near=float(block["z_near_m"]), z_far=float(block["z_far_m"]), split_x=float(block["split_x_m"]),
                 period=int(block["period_frames"]),
                 amplitudes=tuple(float(a) for a in block.get("path_amplitudes", cls.amplitudes)),
                 periods=tuple(int(p) for p in block.get("path_periods_frames", cls.periods)),
                 boot_lateral=float(block.get("bootstrap_lateral_m", BOOT_LATERAL)),
                 tex_scale=float(block.get("texture_px_per_m", TEX_SCALE)))
        if len(sc.amplitudes) != 6 or len(sc.periods) != 6 or min(sc.periods) < 1:
            raise ValueError(f"the path takes six amplitudes and six periods of at least 1 frame: {block}")
        lcm = math.lcm(*(p for a, p in zip(sc.amplitudes, sc.periods) if a))
        if sc.period != lcm:
            raise ValueError(f"period_frames {sc.period} is not the path's period {lcm}, the least common multiple "
                             f"of its periods")
        return sc

    def twist(self, i: int) -> np.ndarray:
        """The twist (v, w) of frame ``i``'s world→camera pose."""
        tau = [a * np.sin(2.0 * np.pi * i / float(p)) if a else 0.0 for a, p in zip(self.amplitudes, self.periods)]
        if i == 1:
            tau[0] = self.boot_lateral
        return np.asarray(tau)

    def ring_poses(self) -> np.ndarray:
        """(period + 1, 4, 4) world→camera poses of the ring's rows."""
        rows = [se3_exp(self.twist(k)) if k != 1 else se3_exp(self.twist(self.period + 1))
                for k in range(self.period)]
        rows.append(se3_exp(self.twist(1)))
        return np.stack(rows)


def ring_index(i: int, period: int) -> int:
    """The ring's row of stream frame ``i``: row ``period`` holds frame 1's
    bootstrap form, rows 0 … period − 1 the path's frames modulo the
    period."""
    return period if i == 1 else i % period


def se3_exp(tau) -> np.ndarray:
    """exp of the twist (v, w) as a 4×4 matrix."""
    from scipy.linalg import expm

    xi = np.zeros((4, 4))
    xi[:3, :3] = [[0, -tau[5], tau[4]], [tau[5], 0, -tau[3]], [-tau[4], tau[3], 0]]
    xi[:3, 3] = tau[:3]
    return expm(xi)


def camera(block: dict, scale: float = 1.0) -> SimpleNamespace:
    """A configuration's ``camera`` block (``fx``, ``fy``, ``cx``, ``cy``,
    ``width``, ``height``, ``distortion``), or a copy ``scale`` times its
    size (the CPU rehearsal's; the distortion acts on normalized coordinates
    and is the same)."""
    c = dict(fx=block["fx"], fy=block["fy"], cx=block["cx"], cy=block["cy"], width=int(block["width"]),
             height=int(block["height"]))
    if scale != 1.0:
        c = dict(fx=c["fx"] * scale, fy=c["fy"] * scale, cx=c["cx"] * scale, cy=c["cy"] * scale,
                 width=int(round(c["width"] * scale)), height=int(round(c["height"] * scale)))
    dist = tuple(float(d) for d in block.get("distortion", (0.0,) * 5))
    if len(dist) != 5:
        raise ValueError(f"distortion takes five coefficients (k1, k2, p1, p2, k3): {dist}")
    return SimpleNamespace(**c, dist=dist)


def texture_draw(seed: int, size: int) -> np.ndarray:
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


def smooth_texture(seed: int, device, size: int, blur: float):
    """``smooth_texture(default_rng(seed), size, blur)`` as a float64 tensor
    on ``device``: drawn on the host, blurred and renormalised to [0, 255]
    on the device."""
    import torch

    tex = blur_wrap(torch.from_numpy(texture_draw(seed, size)).to(device), blur / 3.0)
    lo, hi = tex.min(), tex.max()
    return (tex - lo) / (hi - lo) * 255.0


def undistort(xd, yd, dist):
    """The normalized coordinates whose distortion (OpenCV's radial-tangential
    model, ``dist`` = k1, k2, p1, p2, k3) is (``xd``, ``yd``), float64 tensors:
    Newton's method from the distorted point until the largest residual is at
    most ``NEWTON_TOL``."""
    import torch

    k1, k2, p1, p2, k3 = dist
    x, y = xd.clone(), yd.clone()
    for _ in range(NEWTON_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        fx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xd
        fy = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y - yd
        if float(torch.maximum(fx.abs(), fy.abs()).max()) <= NEWTON_TOL:
            return x, y
        dradial = 2.0 * (k1 + r2 * (2.0 * k2 + 3.0 * r2 * k3))  # d radial / dx = x·dradial, d radial / dy = y·dradial
        a = radial + x * dradial * x + 2.0 * p1 * y + 6.0 * p2 * x  # d fx / dx
        b = x * dradial * y + 2.0 * p1 * x + 2.0 * p2 * y  # d fx / dy
        c = y * dradial * x + 2.0 * p1 * x + 2.0 * p2 * y  # d fy / dx
        d = radial + y * dradial * y + 6.0 * p1 * y + 2.0 * p2 * x  # d fy / dy
        det = a * d - b * c
        x, y = x - (d * fx - b * fy) / det, y - (a * fy - c * fx) / det
    raise ValueError(f"the undistortion did not reach {NEWTON_TOL} in {NEWTON_ITERS} steps: distortion {dist}")


def rays(cam, device):
    """(H·W, 3) float64 unit rays of ``cam``'s pixels in the camera's frame,
    row by row; with distortion, through the undistorted normalized
    coordinates."""
    import torch

    f64 = torch.float64
    vv, uu = torch.meshgrid(torch.arange(cam.height, dtype=f64, device=device),
                            torch.arange(cam.width, dtype=f64, device=device), indexing="ij")
    x = (uu.reshape(-1) - cam.cx) / cam.fx
    y = (vv.reshape(-1) - cam.cy) / cam.fy
    if any(cam.dist):
        x, y = undistort(x, y, cam.dist)
    b = torch.stack([x, y, torch.ones_like(x)], -1)
    return b / torch.linalg.norm(b, dim=-1, keepdim=True)


def hits(b, T, sc: Scene):
    """The world points that rays ``b`` ((N, 3), camera frame) hit from the
    world→camera poses ``T`` ((B, 4, 4)): (B, N, 3) float64, and the rays'
    lengths to them (B, N)."""
    import torch

    R, t = T[:, :3, :3], T[:, :3, 3]
    C = -(R.transpose(1, 2) @ t[..., None])[..., 0]  # (B, 3) camera centres in the world
    dirs = b[None] @ R  # (B, N, 3): Rᵀ b a row
    lam_near = (sc.z_near - C[:, None, 2]) / dirs[..., 2]
    lam_far = (sc.z_far - C[:, None, 2]) / dirs[..., 2]
    p_near = C[:, None] + lam_near[..., None] * dirs
    p_far = C[:, None] + lam_far[..., None] * dirs
    near = p_near[..., 0] < sc.split_x
    return torch.where(near[..., None], p_near, p_far), torch.where(near, lam_near, lam_far)


def render(tex, T, cam, sc: Scene):
    """The ridge under ``tex`` (float64 (S, S) tensor) seen by ``cam`` from
    the world→camera poses ``T`` ((B, 4, 4) float64 tensor on ``tex``'s
    device): (B, H, W) float64 in [0, 255]."""
    return sample(tex, hits(rays(cam, tex.device), T, sc)[0], sc).reshape(-1, cam.height, cam.width)


def sample(tex, pts, sc: Scene):
    """``tex`` at the world points ``pts`` (..., 3), bilinear, clamped at the
    texture's edge."""
    import torch

    c = tex.shape[0] / 2.0
    u = torch.clamp(pts[..., 0] * sc.tex_scale + c, 0.0, tex.shape[1] - 1.001)
    v = torch.clamp(pts[..., 1] * sc.tex_scale + c, 0.0, tex.shape[0] - 1.001)
    x0, y0 = torch.floor(u), torch.floor(v)
    wx, wy = u - x0, v - y0
    x0, y0 = x0.long(), y0.long()
    Wt = tex.shape[1]
    flat = tex.reshape(-1)

    def at(yy, xx):
        return flat[yy * Wt + xx]

    return ((at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx) * (1 - wy)
            + (at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx) * wy)


def render_np(tex: np.ndarray, T: np.ndarray, cam, sc: Scene) -> np.ndarray:
    """``render`` in numpy for one pose and a camera without distortion:
    bench.py's ``render_ridge`` without supersampling."""
    if any(cam.dist):
        raise ValueError("render_np takes a camera without distortion")
    H, W = cam.height, cam.width
    vv, uu = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    x = (uu.ravel() - cam.cx) / cam.fx
    y = (vv.ravel() - cam.cy) / cam.fy
    b = np.stack([x, y, np.ones_like(x)], axis=-1)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    R, t = T[:3, :3], T[:3, 3]
    C = -R.T @ t
    dirs = b @ R
    p_near = C[None] + ((sc.z_near - C[2]) / dirs[:, 2])[:, None] * dirs
    p_far = C[None] + ((sc.z_far - C[2]) / dirs[:, 2])[:, None] * dirs
    pts = np.where((p_near[:, 0] < sc.split_x)[:, None], p_near, p_far)
    c = tex.shape[0] / 2.0
    u = np.clip(pts[:, 0] * sc.tex_scale + c, 0.0, tex.shape[1] - 1.001)
    v = np.clip(pts[:, 1] * sc.tex_scale + c, 0.0, tex.shape[0] - 1.001)
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
    """A stream's frames: ``frames`` (period + 1, H, W) uint8 on the host, the
    rows of ``ring_index``; ``poses`` (period + 1, 4, 4) their world→camera truth.
    ``frame(i)`` and ``truth(i)`` are stream frame i's."""

    def __init__(self, frames: np.ndarray, poses: np.ndarray, period: int):
        self.frames = frames
        self.poses = poses
        self.period = period

    def frame(self, i: int) -> np.ndarray:
        return self.frames[ring_index(i, self.period)]

    def truth(self, i: int) -> np.ndarray:
        return self.poses[ring_index(i, self.period)]


def check_extent(lo, hi, sc: Scene):
    """Refuses a scene whose rays, at the camera and poses rendered, reach
    world points at (x, y) outside [``lo``, ``hi``] that lie off its texture
    (``sc.texture_size`` texels at ``sc.tex_scale`` a metre, centred), or
    meet the planes behind the camera (``lo`` holds the least ray length)."""
    c = sc.texture_size / 2.0
    top = sc.texture_size - 1.001
    texels = [float(v) * sc.tex_scale + c for v in (lo[0], hi[0], lo[1], hi[1])]
    if not (all(math.isfinite(v) for v in texels + [float(lo[2])]) and lo[2] > 0.0
            and all(0.0 <= v <= top for v in texels)):
        raise ValueError(f"a pixel's ray leaves the texture: world x {lo[0]:.4f}…{hi[0]:.4f} m, y {lo[1]:.4f}…"
                         f"{hi[1]:.4f} m (texels {texels[0]:.1f}…{texels[1]:.1f}, {texels[2]:.1f}…{texels[3]:.1f} "
                         f"of 0…{top}), least ray length {lo[2]:.4f} m")


def build_ring(seed: int, device, cam, sc: Scene, texture_size: Optional[int] = None,
               poses: Optional[np.ndarray] = None) -> Ring:
    """The ring of texture ``seed``: drawn, blurred and rendered on
    ``device`` in batches of at most ``RENDER_PIXELS`` pixels (and
    ``RENDER_FRAMES`` frames), each batch copied to the host as 8-bit frames.
    Refuses a scene where some pixel's ray, at some pose, leaves the
    configuration's texture (``check_extent``). ``texture_size``: a smaller
    texture drawn in its place (the CPU rehearsal's and the tests'), which
    the rays may leave: it is sampled with a clamp at its edge."""
    import torch

    poses = sc.ring_poses() if poses is None else poses
    tex = smooth_texture(seed, device, texture_size or sc.texture_size, sc.texture_blur)
    T = torch.from_numpy(poses).to(device)
    b = rays(cam, device)
    batch = max(1, min(RENDER_FRAMES, RENDER_PIXELS // (cam.height * cam.width)))
    out = np.empty((len(poses), cam.height, cam.width), np.uint8)
    ext = []  # each batch's least x, y and ray length, and largest x, y
    for k in range(0, len(poses), batch):
        pts, lam = hits(b, T[k:k + batch], sc)
        ext.append(torch.stack([pts[..., 0].min(), pts[..., 1].min(), lam.min(), pts[..., 0].max(),
                                pts[..., 1].max()]))
        out[k:k + batch] = to_u8(sample(tex, pts, sc).reshape(-1, cam.height, cam.width)).cpu().numpy()
        del pts, lam
    del tex
    ext = torch.stack(ext).cpu().numpy()  # numpy's min and max keep a nan
    check_extent(ext[:, :3].min(0), ext[:, 3:].max(0), sc)
    return Ring(out, poses, sc.period)
