"""The scene: the path's period, frame 1's bootstrap form, the renderer in
PyTorch against the numpy formula, the texture's blur against scipy's."""

import numpy as np
import pytest
import torch

from benchmark import scene


@pytest.mark.parametrize("i", [2, 3, 17, 100, 359, 719, 1000])
def test_frames_a_period_apart_share_a_pose(i):
    a, b = scene.se3_exp(scene.twist(i)), scene.se3_exp(scene.twist(i + scene.PERIOD))
    np.testing.assert_allclose(a, b, atol=1e-12)
    assert scene.ring_index(i) == scene.ring_index(i + scene.PERIOD) == i % scene.PERIOD


def test_the_ring_holds_the_bootstrap_frame_apart():
    poses = scene.ring_poses()
    assert poses.shape == (scene.PERIOD + 1, 4, 4)
    assert scene.ring_index(1) == scene.PERIOD and scene.ring_index(721) == 1
    np.testing.assert_allclose(poses[scene.PERIOD], scene.se3_exp(scene.twist(1)))
    np.testing.assert_allclose(poses[1], scene.se3_exp(scene.twist(scene.PERIOD + 1)), atol=1e-12)
    assert abs(poses[scene.PERIOD][0, 3] - poses[1][0, 3]) > 0.05  # the bootstrap baseline differs


def test_the_renderer_is_the_numpy_formula():
    cam = scene.camera(0.1)
    tex = np.random.default_rng(3).uniform(0, 255, (256, 256))
    poses = scene.ring_poses()[[0, 5, 720]]
    got = scene.render(torch.from_numpy(tex), torch.from_numpy(poses), cam).numpy()
    for k, T in enumerate(poses):
        np.testing.assert_allclose(got[k], scene.render_np(tex, T, cam), rtol=0, atol=1e-9)


def test_the_blur_is_scipys_wrapped_gaussian():
    from scipy.ndimage import gaussian_filter

    draw = scene.texture_draw(5, 96)
    np.testing.assert_allclose(scene.blur_wrap(torch.from_numpy(draw), 13 / 3.0).numpy(),
                               gaussian_filter(draw, sigma=13 / 3.0, mode="wrap"), rtol=0, atol=1e-9)
    tex = scene.smooth_texture(5, "cpu", 96)
    assert float(tex.min()) == 0.0 and abs(float(tex.max()) - 255.0) < 1e-9


def test_a_ring_is_eight_bit_and_seeded():
    cam = scene.camera(0.05)
    poses = scene.ring_poses()
    a = scene.build_ring(2 ** 31 + 7, "cpu", cam, 128, poses=poses)
    b = scene.build_ring(2 ** 31 + 7, "cpu", cam, 128, poses=poses)
    c = scene.build_ring(2 ** 31 + 8, "cpu", cam, 128, poses=poses)
    assert a.frames.dtype == np.uint8 and a.frames.shape == (scene.PERIOD + 1, cam.height, cam.width)
    assert np.array_equal(a.frames, b.frames) and not np.array_equal(a.frames, c.frames)
    assert np.array_equal(a.frame(725), a.frame(5)) and np.array_equal(a.frame(1), a.frames[scene.PERIOD])
