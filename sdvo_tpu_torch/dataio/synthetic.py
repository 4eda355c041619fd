"""Synthetic scene rendering (numpy) — copy of ``sdvo_tpu.dataio.synthetic``
(``smooth_texture``, ``render_ridge``, ``render_plane``) so ``chip_smoke.py``
and the port's tests render scenes without importing the JAX package.

A textured plane (or two-depth ridge) is rendered into any camera pose by
ray-plane intersection + bilinear texture lookup, giving photometrically
consistent frames with exact ground-truth geometry. ``T_wc`` is any object
with numpy-convertible ``rotation`` (3, 3) and ``translation`` (3,).
"""

import numpy as np


def smooth_texture(rng, size=2048, blur=9):
    """Smooth random texture in [0, 255]."""
    from scipy.ndimage import gaussian_filter

    tex = rng.uniform(0.0, 255.0, size=(size, size))
    tex = gaussian_filter(tex, sigma=blur / 3.0, mode="wrap")
    # renormalize contrast
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255.0
    return tex


def _np_bilinear(image: np.ndarray, uv: np.ndarray) -> np.ndarray:
    H, W = image.shape
    x = np.clip(uv[..., 0], 0.0, W - 1.001)
    y = np.clip(uv[..., 1], 0.0, H - 1.001)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    wx = x - x0
    wy = y - y0
    i00 = image[y0, x0]
    i01 = image[y0, x0 + 1]
    i10 = image[y0 + 1, x0]
    i11 = image[y0 + 1, x0 + 1]
    return (i00 * (1 - wx) + i01 * wx) * (1 - wy) + (i10 * (1 - wx) + i11 * wx) * wy


def _np_pyrdown(img: np.ndarray) -> np.ndarray:
    from scipy.ndimage import correlate1d

    k = np.array([1, 4, 6, 4, 1]) / 16.0
    blurred = correlate1d(correlate1d(img, k, axis=0, mode="mirror"), k, axis=1, mode="mirror")
    return blurred[::2, ::2]


def _camera_rays(cam, T_wc, supersample):
    s = int(supersample)
    H, W = cam.height * s, cam.width * s
    vv, uu = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    u = uu.ravel() / s
    v = vv.ravel() / s
    fx, fy, cx, cy = (float(np.asarray(getattr(cam, n))) for n in ("fx", "fy", "cx", "cy"))
    x = (u - cx) / fx
    y = (v - cy) / fy
    b = np.stack([x, y, np.ones_like(x)], axis=-1)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    R = np.asarray(T_wc.rotation, np.float64)
    t = np.asarray(T_wc.translation, np.float64)
    C = -R.T @ t  # camera center in world
    dirs_w = b @ R  # R.T @ b per row
    return (H, W), C, dirs_w


def render_plane(texture, cam, T_wc, plane_z: float = 10.0, tex_scale: float = 40.0,
                 supersample: int = 2):
    """Render the plane z_w = plane_z textured by ``texture``.

    Texture coords: (x_w, y_w) * tex_scale + center. T_wc maps world→camera.
    ``supersample``× oversampling + Gaussian pyrDown keeps image pairs
    band-limited and photometrically consistent. Returns (H, W) numpy array.
    """
    s = int(supersample)
    (H, W), C, dirs_w = _camera_rays(cam, T_wc, s)
    lam = (plane_z - C[2]) / dirs_w[:, 2]
    pts_w = C[None, :] + lam[:, None] * dirs_w
    tex_c = texture.shape[0] / 2.0
    tex_uv = np.stack([pts_w[:, 0] * tex_scale + tex_c, pts_w[:, 1] * tex_scale + tex_c], axis=-1)
    img = _np_bilinear(np.asarray(texture), tex_uv).reshape(H, W)
    for _ in range(max(s.bit_length() - 1, 0)):
        img = _np_pyrdown(img)
    return img


def render_ridge(texture, cam, T_wc, z_near: float = 8.0, z_far: float = 14.0,
                 split_x: float = 0.0, tex_scale: float = 40.0, supersample: int = 2):
    """Render a two-depth scene: plane z=z_near for world x < split_x, plane
    z=z_far otherwise. Non-planar structure avoids the planar degeneracy of
    essential-matrix bootstrapping (a single plane makes E ill-posed)."""
    s = int(supersample)
    (H, W), C, dirs_w = _camera_rays(cam, T_wc, s)
    lam_near = (z_near - C[2]) / dirs_w[:, 2]
    lam_far = (z_far - C[2]) / dirs_w[:, 2]
    p_near = C[None, :] + lam_near[:, None] * dirs_w
    p_far = C[None, :] + lam_far[:, None] * dirs_w
    use_near = p_near[:, 0] < split_x
    pts_w = np.where(use_near[:, None], p_near, p_far)
    tex_c = texture.shape[0] / 2.0
    tex_uv = np.stack([pts_w[:, 0] * tex_scale + tex_c, pts_w[:, 1] * tex_scale + tex_c], axis=-1)
    img = _np_bilinear(np.asarray(texture), tex_uv).reshape(H, W)
    for _ in range(max(s.bit_length() - 1, 0)):
        img = _np_pyrdown(img)
    return img


KITTI_CAMERA = dict(fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854, width=1241, height=376)


def render_bench_sequence(rng, n_frames: int):
    """The scene of ``bench.py`` (``render_sequence``): a ridge at 12/18 m
    under a bounded forward+lateral trajectory with KITTI-scale motion, at
    KITTI geometry. Returns (frames, world→camera 4×4 ground-truth poses)."""
    from types import SimpleNamespace

    from scipy.linalg import expm

    tex = smooth_texture(rng, size=4096, blur=13)
    cam = SimpleNamespace(**KITTI_CAMERA)

    class _Pose:
        def __init__(self, T):
            self.rotation = T[:3, :3]
            self.translation = T[:3, 3]

    frames, T_true = [], []
    for i in range(n_frames):
        # frame 1 takes a lateral baseline for the two-view bootstrap
        lat = 0.15 if i == 1 else 0.30 * np.sin(2.0 * np.pi * i / 36.0)
        tau = np.asarray([
            lat, 0.03 * np.sin(4.0 * np.pi * i / 36.0), 0.18 * np.sin(2.0 * np.pi * i / 48.0),
            0.002 * np.sin(2.0 * np.pi * i / 36.0), 0.005 * np.sin(2.0 * np.pi * i / 30.0), 0.0,
        ])
        xi = np.zeros((4, 4))
        xi[:3, :3] = [[0, -tau[5], tau[4]], [tau[5], 0, -tau[3]], [-tau[4], tau[3], 0]]
        xi[:3, 3] = tau[:3]
        T44 = expm(xi)
        T_true.append(T44)
        frames.append(render_ridge(tex, cam, _Pose(T44), z_near=12.0, z_far=18.0, split_x=-1.5,
                                   supersample=1))
    return frames, T_true


def render_bench_sequences(seeds, n_frames: int):
    """``render_bench_sequence`` for each texture seed (the camera path is the
    same), as float32 frames, one after the other in this process. Returns a
    list of (frames, ground-truth poses)."""
    out = []
    for seed in seeds:
        frames, T_true = render_bench_sequence(np.random.default_rng(seed), n_frames)
        out.append(([f.astype(np.float32) for f in frames], T_true))
    return out
