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


def _se3_exp(tau) -> np.ndarray:
    """exp of the twist (v, w) as a 4×4 matrix."""
    from scipy.linalg import expm

    xi = np.zeros((4, 4))
    xi[:3, :3] = [[0, -tau[5], tau[4]], [tau[5], 0, -tau[3]], [-tau[4], tau[3], 0]]
    xi[:3, 3] = tau[:3]
    return expm(xi)


class _Pose:
    def __init__(self, T):
        self.rotation = T[:3, :3]
        self.translation = T[:3, 3]


KITTI_CAMERA = dict(fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854, width=1241, height=376)


def render_bench_sequence(rng, n_frames: int, start: int = 0):
    """The scene of ``bench.py`` (``render_sequence``): a ridge at 12/18 m
    under a bounded forward+lateral trajectory with KITTI-scale motion, at
    KITTI geometry. Returns (frames, world→camera 4×4 ground-truth poses) of
    frames ``start`` to ``n_frames`` − 1: the texture comes from ``rng``, a
    frame's pose from its index alone."""
    from types import SimpleNamespace

    tex = smooth_texture(rng, size=4096, blur=13)
    cam = SimpleNamespace(**KITTI_CAMERA)
    frames, T_true = [], []
    for i in range(start, n_frames):
        # frame 1 takes a lateral baseline for the two-view bootstrap
        lat = 0.15 if i == 1 else 0.30 * np.sin(2.0 * np.pi * i / 36.0)
        tau = np.asarray([
            lat, 0.03 * np.sin(4.0 * np.pi * i / 36.0), 0.18 * np.sin(2.0 * np.pi * i / 48.0),
            0.002 * np.sin(2.0 * np.pi * i / 36.0), 0.005 * np.sin(2.0 * np.pi * i / 30.0), 0.0,
        ])
        T44 = _se3_exp(tau)
        T_true.append(T44)
        frames.append(render_ridge(tex, cam, _Pose(T44), z_near=12.0, z_far=18.0, split_x=-1.5,
                                   supersample=1))
    return frames, T_true


_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _render_bench_slice(task):
    seed, start, stop = task
    frames, T_true = render_bench_sequence(np.random.default_rng(seed), stop, start)
    return [f.astype(np.float32) for f in frames], T_true


def render_bench_sequences(seeds, n_frames, processes: int = 1):
    """``render_bench_sequence`` for each texture seed (the camera path is the
    same), as float32 frames; ``n_frames`` is one length for all or one a
    seed. With ``processes`` > 1 the frames are rendered in that many spawned
    processes, each sequence cut into slices of consecutive frames (each
    slice draws its seed's texture again), with the bits of one process.
    Returns a list of (frames, ground-truth poses)."""
    lengths = [n_frames] * len(seeds) if isinstance(n_frames, int) else list(n_frames)
    if processes <= 1:
        return [_render_bench_slice((seed, 0, n)) for seed, n in zip(seeds, lengths)]
    import concurrent.futures
    import multiprocessing
    import os

    step = max(1, -(-sum(lengths) // processes))
    tasks = [(k, (seed, lo, min(lo + step, n))) for k, (seed, n) in enumerate(zip(seeds, lengths))
             for lo in range(0, n, step)]
    # one BLAS/OpenMP thread a process (the processes are the parallelism),
    # set before they start: a spawned process reads these at its first import
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: "1" for k in _THREAD_VARS})
    try:
        with concurrent.futures.ProcessPoolExecutor(processes,
                                                    mp_context=multiprocessing.get_context("spawn")) as pool:
            parts = list(pool.map(_render_bench_slice, [t for _, t in tasks]))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = [([], []) for _ in seeds]
    for (k, _), (frames, T_true) in zip(tasks, parts):
        out[k][0].extend(frames)
        out[k][1].extend(T_true)
    return out


LONG_CAMERA = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240)


def long_sweep_pose(i: float) -> np.ndarray:
    """World→camera pose of frame ``i`` of the long run's slow figure sweep
    with turns (``tests/test_long_sequence.py``'s camera path)."""
    return _se3_exp(np.asarray([
        0.5 * np.sin(2 * np.pi * i / 120.0), 0.05 * np.sin(2 * np.pi * i / 80.0),
        0.4 * np.sin(2 * np.pi * i / 150.0), 0.002 * np.sin(2 * np.pi * i / 120.0),
        0.01 * np.sin(2 * np.pi * i / 100.0), 0.0]))


def render_long_sequence(n_frames: int, black, seed: int = 11, poses=None, blur: int = 13):
    """The long run's scene: a ridge at 8/14 m split at x = 1 under
    ``smooth_texture(size=3072, blur=blur)`` from ``seed``, 320×240, no
    supersampling, frames ``black`` all zero. ``poses`` (4×4 each) replace
    the figure sweep. Returns (float32 frames, world→camera poses)."""
    from types import SimpleNamespace

    tex = smooth_texture(np.random.default_rng(seed), size=3072, blur=blur)
    cam = SimpleNamespace(**LONG_CAMERA)
    T_true = [long_sweep_pose(i) for i in range(n_frames)] if poses is None else list(poses)
    frames = [np.zeros((cam.height, cam.width), np.float32) if i in black else
              render_ridge(tex, cam, _Pose(T), z_near=8.0, z_far=14.0, split_x=1.0, supersample=1)
              .astype(np.float32) for i, T in enumerate(T_true)]
    return frames, T_true


EUROC_CAMERA = dict(fx=458.0, fy=457.0, cx=376.0, cy=240.0, width=752, height=480)
DOLLY_STEP = (0.12, 0.015, 0.04, 0.0, 0.002, 0.0)  # a frame of the sideways-dominant dolly


def render_dolly_sequence(cam: dict, n_frames: int, seed: int, step=DOLLY_STEP):
    """``tests/test_pipeline_e2e.py::make_sequence``'s scene in the camera
    ``cam``: a ridge at 8/14 m split at x = 1 under
    ``smooth_texture(size=3072, blur=13)`` from ``seed``, rendered with 2×
    supersampling and cut to uint8, the world→camera pose of frame i
    exp(i·``step``). Returns (uint8 frames, poses)."""
    from types import SimpleNamespace

    tex = smooth_texture(np.random.default_rng(seed), size=3072, blur=13)
    c = SimpleNamespace(**cam)
    T_true = [_se3_exp(np.asarray(step, np.float64) * i) for i in range(n_frames)]
    frames = [render_ridge(tex, c, _Pose(T), z_near=8.0, z_far=14.0, split_x=1.0).astype(np.uint8)
              for T in T_true]
    return frames, T_true


def render_plane_track(rng, cam: dict, dtau, n_frames: int, n_features: int, n_filters: int,
                       plane_z: float = 10.0, margin: float = 20.0, tex_size: int = 1024, blur: int = 9,
                       supersample: int = 2):
    """The streaming tracker's scene: a textured plane at ``plane_z`` seen
    from the reference keyframe (the world frame) and from the world→camera
    poses exp(i·dtau), i = 1 … ``n_frames``; ``n_features`` alignment
    features and ``n_filters`` depth-filter seeds at random pixels at least
    ``margin`` px inside the reference image. Returns a namespace: ``ref``
    (H, W) and ``frames`` (F, H, W) float32, ``T_true`` (4×4 each), ``uv``
    (N, 2) float32 and ``points`` (N, 3) float32 on the plane in the
    reference frame, ``filter_uv`` (C, 2) and ``filter_bearing`` (C, 3) unit
    float32, ``filter_depth`` (C,) float64 along each bearing to the plane."""
    from types import SimpleNamespace

    c = SimpleNamespace(**cam)
    W, H = c.width, c.height
    tex = smooth_texture(rng, size=tex_size, blur=blur)
    ref = render_plane(tex, c, _Pose(np.eye(4)), plane_z, supersample=supersample).astype(np.float32)
    T_true = [_se3_exp(np.asarray(dtau, np.float64) * i) for i in range(1, n_frames + 1)]
    frames = np.stack([render_plane(tex, c, _Pose(T), plane_z, supersample=supersample)
                       for T in T_true]).astype(np.float32)

    def rays(uv):
        return np.stack([(uv[:, 0] - c.cx) / c.fx, (uv[:, 1] - c.cy) / c.fy, np.ones(len(uv))], -1)

    uv = rng.uniform([margin, margin], [W - margin, H - margin], (n_features, 2))
    fuv = rng.uniform([margin, margin], [W - margin, H - margin], (n_filters, 2))
    fb = rays(fuv)
    fb /= np.linalg.norm(fb, axis=-1, keepdims=True)
    return SimpleNamespace(ref=ref, frames=frames, T_true=T_true, uv=uv.astype(np.float32),
                           points=(rays(uv) * plane_z).astype(np.float32), filter_uv=fuv.astype(np.float32),
                           filter_bearing=fb.astype(np.float32), filter_depth=plane_z / fb[:, 2])
