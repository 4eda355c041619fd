"""The scene: read from a configuration's file, the path's period, frame 1's
bootstrap form, the renderer in PyTorch against the numpy formula, the
texture's blur against scipy's; the rings of the committed configurations
byte for byte those of the constants the harness held before it read the
file; the camera each side of the check gets; a distorted camera's rays;
rays that leave the texture refused."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.harness import check, drive, spec

CONFIGS = {c: spec.load_json(f"{spec.BENCH_DIR}/configs/{c}.json") for c in ("kitti_mono", "kitti_mono_x8")}
SC = scene.Scene.of(CONFIGS["kitti_mono"]["scene"])

# what the harness held as constants before it read the configuration's file
FROZEN_PERIOD, FROZEN_BOOT = 720, 0.15
FROZEN_CAMERA = dict(fx=721.5377, fy=721.5377, cx=609.5593, cy=172.854, width=1241, height=376)
FROZEN_SCENE = scene.Scene(texture_size=4096, texture_blur=13, z_near=12.0, z_far=18.0, split_x=-1.5,
                           period=720, amplitudes=(1.0,) * 6, periods=(1,) * 6, boot_lateral=0.0, tex_scale=40.0)
EUROC = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480,
             distortion=[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])


def frozen_twist(i):
    lat = FROZEN_BOOT if i == 1 else 0.30 * np.sin(2.0 * np.pi * i / 36.0)
    return np.asarray([
        lat, 0.03 * np.sin(4.0 * np.pi * i / 36.0), 0.18 * np.sin(2.0 * np.pi * i / 48.0),
        0.002 * np.sin(2.0 * np.pi * i / 36.0), 0.005 * np.sin(2.0 * np.pi * i / 30.0), 0.0,
    ])


def frozen_poses():
    rows = [scene.se3_exp(frozen_twist(k)) if k != 1 else scene.se3_exp(frozen_twist(FROZEN_PERIOD + 1))
            for k in range(FROZEN_PERIOD)]
    return np.stack(rows + [scene.se3_exp(frozen_twist(1))])


def frozen_camera(scale):
    c = FROZEN_CAMERA
    return SimpleNamespace(fx=c["fx"] * scale, fy=c["fy"] * scale, cx=c["cx"] * scale, cy=c["cy"] * scale,
                           width=int(round(c["width"] * scale)), height=int(round(c["height"] * scale)),
                           dist=(0.0,) * 5)


@pytest.mark.parametrize("i", [2, 3, 17, 100, 359, 719, 1000])
def test_frames_a_period_apart_share_a_pose(i):
    a, b = scene.se3_exp(SC.twist(i)), scene.se3_exp(SC.twist(i + SC.period))
    np.testing.assert_allclose(a, b, atol=1e-12)
    assert scene.ring_index(i, SC.period) == scene.ring_index(i + SC.period, SC.period) == i % SC.period


def test_the_ring_holds_the_bootstrap_frame_apart():
    poses = SC.ring_poses()
    assert SC.period == FROZEN_PERIOD and poses.shape == (SC.period + 1, 4, 4)
    assert scene.ring_index(1, SC.period) == SC.period and scene.ring_index(721, SC.period) == 1
    np.testing.assert_allclose(poses[SC.period], scene.se3_exp(SC.twist(1)))
    np.testing.assert_allclose(poses[1], scene.se3_exp(SC.twist(SC.period + 1)), atol=1e-12)
    assert abs(poses[SC.period][0, 3] - poses[1][0, 3]) > 0.05  # the bootstrap baseline differs


def test_the_renderer_is_the_numpy_formula():
    cam = scene.camera(CONFIGS["kitti_mono"]["camera"], 0.1)
    tex = np.random.default_rng(3).uniform(0, 255, (256, 256))
    poses = SC.ring_poses()[[0, 5, 720]]
    got = scene.render(torch.from_numpy(tex), torch.from_numpy(poses), cam, SC).numpy()
    for k, T in enumerate(poses):
        np.testing.assert_allclose(got[k], scene.render_np(tex, T, cam, SC), rtol=0, atol=1e-9)


def test_the_blur_is_scipys_wrapped_gaussian():
    from scipy.ndimage import gaussian_filter

    draw = scene.texture_draw(5, 96)
    np.testing.assert_allclose(scene.blur_wrap(torch.from_numpy(draw), 13 / 3.0).numpy(),
                               gaussian_filter(draw, sigma=13 / 3.0, mode="wrap"), rtol=0, atol=1e-9)
    tex = scene.smooth_texture(5, "cpu", 96, 13)
    assert float(tex.min()) == 0.0 and abs(float(tex.max()) - 255.0) < 1e-9


def test_a_ring_is_eight_bit_and_seeded():
    cam = scene.camera(CONFIGS["kitti_mono"]["camera"], 0.05)
    poses = SC.ring_poses()
    a = scene.build_ring(2 ** 31 + 7, "cpu", cam, SC, 128, poses=poses)
    b = scene.build_ring(2 ** 31 + 7, "cpu", cam, SC, 128, poses=poses)
    c = scene.build_ring(2 ** 31 + 8, "cpu", cam, SC, 128, poses=poses)
    assert a.frames.dtype == np.uint8 and a.frames.shape == (SC.period + 1, cam.height, cam.width)
    assert np.array_equal(a.frames, b.frames) and not np.array_equal(a.frames, c.frames)
    assert np.array_equal(a.frame(725), a.frame(5)) and np.array_equal(a.frame(1), a.frames[SC.period])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_ring_from_the_file_is_the_frozen_constants(name):
    """The configuration's file, read, renders the ring that the constants
    the harness held render, byte for byte, poses and frames."""
    cfg = CONFIGS[name]
    sc, cam = scene.Scene.of(cfg["scene"]), scene.camera(cfg["camera"], 0.1)
    assert vars(cam) == vars(frozen_camera(0.1))
    got = scene.build_ring(2 ** 31 + 7, "cpu", cam, sc, 128)
    # the frozen path through poses of its own; the amplitudes, periods and baseline above are never read
    want = scene.build_ring(2 ** 31 + 7, "cpu", frozen_camera(0.1), FROZEN_SCENE, 128, poses=frozen_poses())
    assert got.poses.tobytes() == want.poses.tobytes() and got.frames.tobytes() == want.frames.tobytes()
    assert got.period == FROZEN_PERIOD and got.frames.shape == (FROZEN_PERIOD + 1, 38, 124)
    assert sc.texture_size == 4096 and sc.texture_blur == 13 and (sc.z_near, sc.z_far, sc.split_x) == (12, 18, -1.5)


def test_the_render_batch_does_not_change_a_frame(monkeypatch):
    # a 1920×1080 ring renders 10 frames at once, a KITTI one 48
    assert scene.RENDER_PIXELS // (1920 * 1080) == 10 and scene.RENDER_PIXELS // (1241 * 376) == 48
    cam = scene.camera(CONFIGS["kitti_mono"]["camera"], 0.05)
    poses = SC.ring_poses()[:40]
    a = scene.build_ring(2 ** 31 + 9, "cpu", cam, SC, 128, poses=poses)
    monkeypatch.setattr(scene, "RENDER_PIXELS", 7 * cam.height * cam.width)  # batches of 7 frames, not 40
    b = scene.build_ring(2 ** 31 + 9, "cpu", cam, SC, 128, poses=poses)
    assert a.frames.tobytes() == b.frames.tobytes()


def test_the_port_and_the_reference_get_the_frozen_camera():
    from benchmark.reference import PinholeCamera
    from sdvo_tpu_torch.pipeline.system import System

    cfg = CONFIGS["kitti_mono"]
    cam = scene.camera(cfg["camera"])
    config = drive.port_config(cfg["settings"])
    assert drive.port_camera(cam, config) is None  # the system's own default camera
    host = System(config, drive.port_camera(cam, config), device="cpu")
    assert tuple(host.camera) == tuple(PinholeCamera.create(**FROZEN_CAMERA, dtype=torch.float32))
    ref = check.Reference(cfg["settings"], cam, "cpu")
    assert ref.vo.cam == PinholeCamera.create(**FROZEN_CAMERA, dtype=torch.float32)
    # the CPU rehearsal's camera, scaled: its own, as before
    half = drive.port_camera(scene.camera(cfg["camera"], 0.5), config)
    assert tuple(half) == tuple(PinholeCamera.create(**vars(frozen_camera(0.5)), dtype=torch.float32))


def test_another_fx_at_kitti_size_gets_its_own_camera():
    """A camera of KITTI's width and height is not KITTI's camera."""
    cfg = CONFIGS["kitti_mono"]
    config = drive.port_config(cfg["settings"])
    for change in ({"fx": 700.0}, {"cy": 180.0}, {"distortion": [-0.1, 0, 0, 0, 0]}):
        cam = scene.camera({**cfg["camera"], **change})
        got = drive.port_camera(cam, config)
        assert got is not None and (got.fx, got.cy, got.dist[0]) == (
            np.float32(cam.fx), np.float32(cam.cy), np.float32(cam.dist[0]))
        ref = check.Reference(cfg["settings"], cam, "cpu").vo.cam
        assert tuple(ref) == tuple(got)


def distort_np(x, y, k1, k2, p1, p2, k3):
    """OpenCV's radial-tangential model, written out again."""
    r2 = x ** 2 + y ** 2
    f = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    return x * f + 2 * p1 * x * y + p2 * (r2 + 2 * x ** 2), y * f + p1 * (r2 + 2 * y ** 2) + 2 * p2 * x * y


def test_a_distorted_pixel_projects_back_onto_itself():
    """EuRoC cam0 at a quarter of its size: the world point each pixel's ray
    hits, projected through the lens, lands on that pixel."""
    cam = scene.camera(EUROC, 0.25)
    assert (cam.width, cam.height) == (188, 120) and cam.dist[0] == EUROC["distortion"][0]
    b = scene.rays(cam, "cpu")
    poses = SC.ring_poses()[[0, 1, 7, 500, 720]]
    pts, lam = scene.hits(b, torch.from_numpy(poses), SC)
    vv, uu = np.meshgrid(np.arange(cam.height), np.arange(cam.width), indexing="ij")
    for T, P in zip(poses, pts.numpy()):
        Pc = P @ T[:3, :3].T + T[:3, 3]
        xd, yd = distort_np(Pc[:, 0] / Pc[:, 2], Pc[:, 1] / Pc[:, 2], *cam.dist)
        err = np.hypot(cam.fx * xd + cam.cx - uu.ravel(), cam.fy * yd + cam.cy - vv.ravel())
        assert err.max() < 1e-6, err.max()
    # the corners' rays bend outward: their undistorted coordinates lie beyond the distorted ones
    corner = b[0] / b[0, 2]
    assert corner[0] < -cam.cx / cam.fx - 0.05 and corner[1] < -cam.cy / cam.fy - 0.05


def test_without_distortion_the_rays_are_the_pinhole_formula(monkeypatch):
    def never(*a):
        raise AssertionError("the undistortion ran for a camera without distortion")

    monkeypatch.setattr(scene, "undistort", never)
    cam = scene.camera(CONFIGS["kitti_mono"]["camera"], 0.1)
    got = scene.rays(cam, "cpu").numpy()
    vv, uu = np.meshgrid(np.arange(cam.height, dtype=np.float64), np.arange(cam.width, dtype=np.float64),
                         indexing="ij")
    b = np.stack([(uu.ravel() - cam.cx) / cam.fx, (vv.ravel() - cam.cy) / cam.fy, np.ones(uu.size)], -1)
    np.testing.assert_allclose(got, b / np.linalg.norm(b, axis=-1, keepdims=True), rtol=0, atol=1e-15)


@pytest.mark.parametrize("change", [{"texture_size": 1024}, {"tex_scale": 160.0}, {"z_far": 80.0}])
def test_rays_that_leave_the_texture_are_refused(change):
    import dataclasses

    cam = scene.camera(CONFIGS["kitti_mono"]["camera"], 0.05)
    sc = dataclasses.replace(SC, **change)
    with pytest.raises(ValueError, match="leaves the texture"):
        scene.build_ring(2 ** 31 + 7, "cpu", cam, sc, 128, poses=sc.ring_poses()[:8])
    # the configuration as committed stays on its texture, at EuRoC's distorted camera too
    scene.build_ring(2 ** 31 + 7, "cpu", cam, SC, 128, poses=SC.ring_poses()[:8])
    scene.build_ring(2 ** 31 + 7, "cpu", scene.camera(EUROC, 0.1), SC, 128, poses=SC.ring_poses()[:8])


def test_the_period_is_the_paths():
    block = dict(CONFIGS["kitti_mono"]["scene"])
    assert scene.Scene.of(block).period == 720 == math.lcm(36, 18, 48, 30)
    with pytest.raises(ValueError, match="least common multiple"):
        scene.Scene.of({**block, "period_frames": 360})
    other = scene.Scene.of({**block, "period_frames": 60, "path_periods_frames": [12, 6, 20, 12, 10, 1]})
    np.testing.assert_allclose(scene.se3_exp(other.twist(7)), scene.se3_exp(other.twist(67)), atol=1e-12)
