"""The float64 device path: both packages' ``DeviceSystem`` with
``compute_dtype="float64"`` (the JAX CLI's ``--f64``) on the CPU, over
``test_torch_device_system``'s scene (320×240, 2 + 6 frames, chunks of two
supersteps), and the port's CLI with ``--cpu --f64`` on the device path.

Both bootstrap from the same RANSAC draws. The JAX side runs its CPU default
path (XLA), the port its kernels' plain versions, which compute in float32
inside and hand back float64; so, as for float32
(``test_torch_device_system.test_two_supersteps_track_like_reference``), the
frames are held to the same results and camera centres within 2 % of the
path length. The state is held leaf for leaf to the JAX state's dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.config import load_config as j_load_config
from sdvo_tpu.geometry.camera import PinholeCamera as JCamera
from sdvo_tpu.pipeline.device_system import DeviceSystem as JDeviceSystem

from sdvo_tpu_torch import main as cli
from sdvo_tpu_torch.config import load_config
from sdvo_tpu_torch.convert import to_numpy
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

from test_pipeline_e2e import CAM, make_sequence
from test_torch_device_system import KW, OVERRIDES, _centers
from test_torch_system import _dataset, _uniforms

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    _, images, _ = make_sequence(np.random.default_rng(7), n_frames=8)
    return [np.asarray(im, np.float64) for im in images]


@pytest.fixture(scope="module")
def runs(frames):
    jds = JDeviceSystem(j_load_config(overrides=OVERRIDES).replace(compute_dtype="float64"),
                        camera=JCamera.create(**CAM, dtype=jnp.float64), **KW)
    jds.add_image(frames[0], 0.0)
    uniforms = _uniforms(jds.host)
    tds = DeviceSystem(load_config(overrides=OVERRIDES).replace(compute_dtype="float64"),
                       camera=PinholeCamera.create(**CAM), ransac_uniforms=uniforms, device="cpu", **KW)
    tds.add_image(frames[0], 0.0)
    for i, f in enumerate(frames[1:], start=1):
        jds.add_image(f, float(i))
        tds.add_image(f, float(i))
    jds.finish()
    tds.finish()
    return jds, tds


def test_device_system_in_float64_tracks_like_reference(runs):
    jds, tds = runs
    assert tds.dtype == tds.vo.dtype == torch.float64
    assert len(tds.trajectory) == len(jds.trajectory) == 8 and tds.n_relocalizations == 0
    assert [m["result"] for m in tds.metrics] == [m["result"] for m in jds.metrics]
    cj, ct = _centers(jds.trajectory), _centers(tds.trajectory)
    path = float(np.sum(np.linalg.norm(np.diff(cj, axis=0), axis=-1)))
    err = np.linalg.norm(ct - cj, axis=-1).max()
    assert err < 0.02 * path, (err, path)


def test_device_state_in_float64_has_the_reference_dtypes(runs):
    """Every leaf of the state after the chunks has the JAX state's dtype
    (float64 for every float but the keyframe images' source frames, which
    both packages buffer in float32 and hand over in the compute dtype)."""
    jds, tds = runs
    t_leaves = jax.tree_util.tree_leaves(to_numpy(tds.state))
    j_leaves = jax.tree_util.tree_leaves(jax.device_get(jds.state))
    assert [a.shape for a in t_leaves] == [np.shape(b) for b in j_leaves]
    assert [a.dtype for a in t_leaves] == [np.asarray(b).dtype for b in j_leaves]
    assert tds.state.map.kf_img0.dtype == tds.state.map.pt_pos.dtype == torch.float64


def test_cli_device_path_in_float64(frames, tmp_path, capsys):
    """``--cpu --f64`` runs the device path (``DeviceSystem``) in float64:
    a pose for every frame, none failed."""
    cfg_path, out_dir = _dataset(tmp_path, frames)
    assert cli.main([cfg_path, "--cpu", "--f64", "--chunk", "1"]) == 0
    lines = (out_dir / "out.txt").read_text().strip().splitlines()
    assert len(lines) == 8 and "Failed" not in lines
    assert "8/8 frames tracked" in capsys.readouterr().out
