"""The JAX package's long run (``tests/test_long_sequence.py``), shortened,
through the port's ``DeviceSystem`` and the JAX one on the same frames.

The long run's configuration: its overrides and its ``DeviceSystem``
arguments (chunks of 4 supersteps, 32 promotions, 256 BA points, 4 BA
iterations), 320×240, a ridge at 8/14 m, the slow figure sweep with turns.
Cut to 2 + 51 frames with a blackout of 3 frames (24–26) in the second
chunk: 18 keyframes through the 7-slot window (eviction fires 11 times),
the filter bank of 256 recycled, one relocalization through the host
``System`` and its re-pack into the chunk graph's shape, then two chunks
more on the device; the tail is a whole chunk, so each side builds one
chunk of 4 supersteps. ``chip_smoke.run_long`` runs the whole 300 frames
on the card with the JAX test's gates.

Two changes to the scene, both measured: the sweep runs at twice its speed
(frame i is the long run's frame 2i) and the texture is
``smooth_texture(blur=4)``, not 13. With the long run's own first 50 frames
the two packages give the same results frame by frame, but camera centres
19 % of the path apart; the port against itself with 1e-4 grey levels added
to every other frame moves 32 % of the path: at 30–44 matches a frame the
tracker amplifies any rounding (the JAX CPU path's histogram MAD against
the kernels' binned one is such a rounding), so no tolerance tells a fault
from the noise there. On this scene the same perturbation moves the port
1.1 % of the path before the blackout and 3.1 % over the run, and the two
packages are 0.58 % and 1.87 % apart. The RANSAC draws of every bootstrap
attempt are the JAX ``System``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.config import load_config as j_load_config
from sdvo_tpu.geometry.camera import PinholeCamera as JCamera
from sdvo_tpu.pipeline.device_system import DeviceSystem as JDeviceSystem

from sdvo_tpu_torch.config import load_config
from sdvo_tpu_torch.dataio.synthetic import LONG_CAMERA, long_sweep_pose, render_long_sequence
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

import chip_smoke

torch.set_num_threads(2)

N_FRAMES = 2 + 51
BLACK = range(24, 27)


def _results(ds):
    return [m["result"] for m in ds.metrics]


def _counters(ds):
    """(keyframes ever made, live keyframes), from the device state or the
    host arena."""
    if ds.state is not None:
        return int(np.asarray(ds.state.map.kf_counter)), int(np.asarray(ds.state.map.kf_valid).sum())
    return ds.host.arena.kf_counter, ds.host.arena.num_keyframes()


def _centers(traj, idx):
    return np.asarray([-traj[i][:3, :3].T @ traj[i][:3, 3] for i in idx])


@pytest.fixture(scope="module")
def runs():
    frames, poses = render_long_sequence(N_FRAMES, BLACK, poses=[long_sweep_pose(2 * i) for i in range(N_FRAMES)],
                                         blur=4)
    jds = JDeviceSystem(j_load_config(overrides=chip_smoke.LONG_OVERRIDES),
                        camera=JCamera.create(**LONG_CAMERA, dtype=jnp.float64), **chip_smoke.LONG_KW)
    tds = DeviceSystem(load_config(overrides=chip_smoke.LONG_OVERRIDES), camera=PinholeCamera.create(**LONG_CAMERA),
                       device="cpu", **chip_smoke.LONG_KW)
    key = jax.random.PRNGKey(0)  # the JAX System's; one split a bootstrap attempt
    for i, im in enumerate(frames):
        jds.add_image(np.asarray(im, np.float64), float(i))
        if tds.host.status.name == "PROCESS_SECOND_FRAME":
            key, sub = jax.random.split(key)
            n = len(tds.host.ref_frame.feat_uv)
            tds.host.ransac_uniforms = np.asarray(jax.random.uniform(sub, (256, n), dtype=jnp.float64))
        tds.add_image(np.asarray(im, np.float64), float(i))
    jds.finish()
    tds.finish()
    return jds, tds, poses


def test_long_run_fails_and_recovers_like_jax(runs):
    """The same result for every frame (the blackout's frames FAILED and no
    other), one relocalization in each, the same frames tracked on the host
    and on the device, and the same keyframe counter and live keyframes:
    eviction fired at least 10 times and the window holds 7."""
    jds, tds, _ = runs
    res = _results(tds)
    assert res == _results(jds)
    assert [i for i, r in enumerate(res) if r == "FAILED"] == list(BLACK)
    assert tds.n_relocalizations == jds.n_relocalizations == 1
    via = ["device" if "align_rmse" in m else "host" for m in tds.metrics]
    assert via == ["device" if "align_rmse" in m else "host" for m in jds.metrics]
    chunk = chip_smoke.LONG_KW["supersteps_per_chunk"] * 3
    assert via[:2 + 2 * chunk] == ["host"] * 2 + ["device"] * 2 * chunk  # the blackout's chunk fails
    assert via[2 + 2 * chunk] == "host" and via[-2 * chunk:] == ["device"] * 2 * chunk
    assert tds.state is not None and jds.state is not None
    ever, live = _counters(tds)
    assert (ever, live) == _counters(jds)
    assert live == chip_smoke.long_config().algorithm.max_keyframes and ever - live >= 10
    caps = [m["n_filters"] for m in tds.metrics if "n_filters" in m]
    assert 0 < caps[-1] and max(caps) <= chip_smoke.long_config().algorithm.max_filters


def test_long_run_trajectory_within_band(runs):
    """Camera centres of every tracked frame within 2 % of the path length of
    the JAX run (``test_two_supersteps_track_like_reference``'s tolerance),
    before the blackout and over the whole run; both within the JAX test's
    drift gate against the ground truth (scale-aligned ATE < 12 % of the
    path)."""
    jds, tds, poses = runs
    ok = [i for i, T in enumerate(jds.trajectory) if T is not None]
    cj, ct = _centers(jds.trajectory, ok), _centers(tds.trajectory, ok)
    path = float(np.sum(np.linalg.norm(np.diff(cj, axis=0), axis=-1)))
    gap = np.linalg.norm(ct - cj, axis=-1)
    pre = np.asarray(ok) < BLACK.start
    assert gap[pre].max() < 0.02 * path, (gap[pre].max(), path)
    assert gap.max() < 0.02 * path, (gap.max(), path)
    gt = _centers(poses, ok)
    for c in (cj, ct):
        ate, gpath = chip_smoke.drift(c, gt)
        assert ate / gpath < 0.12
