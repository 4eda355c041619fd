"""The port's measurement entry points on the CPU: ``bench_torch.py``,
``tools/bench_multiseq_torch.py``, ``tools/profile_system_torch.py`` and
``tools/profile_ablate_torch.py``.

Scene: the 320×240 ridge sequences of ``test_pipeline_e2e.make_sequence``
with ``test_torch_device_system``'s configuration (``OVERRIDES``, ``KW``:
chunks of two supersteps). The bench protocol and the multi-sequence bench
run against the JAX package's ``DeviceVO.chunk_fn`` and ``multi_chunk_fn``
(its CPU default, XLA) on the same frames, every system bootstrapped with
the RANSAC draws the JAX ``System`` of seed 0 makes, as
``test_torch_device_system`` does; the XLA path and the kernels' semantics
differ (binned vs histogram MAD, the per-feature freeze of feature
alignment, the iteration taper), so camera centres are held within 2 % of
the path, that file's band.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdvo_tpu.config import load_config as j_load_config
from sdvo_tpu.dataio.evaluate import ate_rmse as j_ate_rmse
from sdvo_tpu.geometry.camera import PinholeCamera as JCamera
from sdvo_tpu.parallel.multi_seq import multi_chunk_fn as j_multi_chunk_fn
from sdvo_tpu.parallel.multi_seq import stack_states as j_stack_states
from sdvo_tpu.pipeline.device_system import DeviceSystem as JDeviceSystem

from sdvo_tpu_torch.config import load_config
from sdvo_tpu_torch.convert import to_numpy
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem, DeviceVO

from test_pipeline_e2e import CAM, make_sequence
from test_torch_device_system import KW, OVERRIDES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import bench_multiseq_torch  # noqa: E402
import bench_torch  # noqa: E402
import profile_ablate_torch  # noqa: E402
import profile_system_torch  # noqa: E402

torch.set_num_threads(2)

SUPERSTEPS = 2  # chunk_fn(2)
PER = 3
PATH_BAND = 0.02  # camera centres against the JAX run, of its path length
ENTRY_POINTS = ("bench_torch.py", "tools/bench_multiseq_torch.py", "tools/profile_system_torch.py",
                "tools/profile_ablate_torch.py")


def _frames(seed, n):
    _, images, poses = make_sequence(np.random.default_rng(seed), n_frames=n)
    return [np.asarray(im, np.float32) for im in images], poses


def _jax_system():
    return JDeviceSystem(j_load_config(overrides=OVERRIDES), camera=JCamera.create(**CAM, dtype=jnp.float64),
                         **KW)


def _uniforms(jds, frame0):
    """The RANSAC draws of the first bootstrap attempt of the JAX ``System``
    of seed 0, after ``jds`` took ``frame0``."""
    jds.add_image(frame0, 0.0)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    return np.asarray(jax.random.uniform(sub, (256, len(jds.host.ref_frame.feat_uv)), dtype=jnp.float64))


def _system(uniforms=None):
    return DeviceSystem(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM),
                        ransac_uniforms=uniforms, device="cpu", **KW)


def _centres(R, t):
    return -np.einsum("...ji,...j->...i", np.asarray(R, np.float64), np.asarray(t, np.float64)).reshape(-1, 3)


def _hold_to_jax(t_out, j_out, c_boot):
    """The same ``ok`` and ``is_kf`` frame for frame, camera centres within
    ``PATH_BAND`` of the JAX run's path (from the bootstrap's second camera
    ``c_boot``)."""
    np.testing.assert_array_equal(np.asarray(t_out.ok).reshape(-1), np.asarray(j_out.ok).reshape(-1))
    np.testing.assert_array_equal(np.asarray(t_out.is_kf).reshape(-1), np.asarray(j_out.is_kf).reshape(-1))
    cj, ct = _centres(j_out.R, j_out.t), _centres(t_out.R, t_out.t)
    path = float(np.sum(np.linalg.norm(np.diff(np.concatenate([c_boot[None], cj]), axis=0), axis=-1)))
    gap = np.linalg.norm(ct - cj, axis=-1).max()
    assert gap < PATH_BAND * path, (gap, path)


def _c_boot(jstate):
    T = jstate.ref.T_ref_w
    return -np.asarray(T.rotation, np.float64).T @ np.asarray(T.translation, np.float64)


def test_run_protocol_matches_jax_and_bench_arithmetic():
    """``bench_torch.run_protocol`` at ``chunk_fn(2)`` (one warm-up chunk,
    one group of two timed chunks) against the JAX ``DeviceVO.chunk_fn(2)``
    on the same frames from the JAX bootstrap: ``ok`` and ``is_kf`` equal
    frame for frame, centres within 2 % of the path; and the port's gate
    values equal ``sdvo_tpu.dataio.evaluate.ate_rmse`` and bench.py's
    arithmetic (``bench.py:190-218``) on the port's own outputs to 1e-12."""
    n_chunks, n = 3, SUPERSTEPS * PER
    frames, poses = _frames(7, 2 + n_chunks * n)
    jds = _jax_system()
    uniforms = _uniforms(jds, frames[0])
    jds.add_image(frames[1], 1.0)
    res = bench_torch.run_protocol(_system(uniforms), frames, poses, supersteps=SUPERSTEPS, groups=1, timed=2)

    fn, state, j_outs = jds.vo.chunk_fn(SUPERSTEPS), jds.state, []
    c_boot = _c_boot(jax.device_get(state))
    for c in range(n_chunks):
        imgs = np.stack(frames[2 + c * n:2 + (c + 1) * n]).reshape(SUPERSTEPS, PER, *frames[0].shape)
        state, out = fn(state, jnp.asarray(imgs))
        j_outs.append(jax.device_get(out))
    j_out = type(j_outs[0])(*[np.concatenate([np.reshape(o[i], (n,) + np.shape(o[i])[2:]) for o in j_outs])
                               for i in range(len(j_outs[0]))])
    _hold_to_jax(res["out"], j_out, c_boot)
    assert len(res["chunk_s"]) == len(res["fps_chunks"]) == 2 and len(res["fps_groups"]) == 1
    assert res["frames"] == n_chunks * n and res["pool_bytes"] is None

    # bench.py's arithmetic, frame by frame, on the port's outputs
    out, est, gt, oks, n_kf = res["out"], [], [], [], 0
    for i in range(len(out.ok)):
        oks.append(bool(out.ok[i]))
        n_kf += int(out.is_kf[i])
        T = np.eye(4)
        T[:3, :3] = out.R[i]
        T[:3, 3] = out.t[i]
        est.append(-T[:3, :3].T @ T[:3, 3])
        Tg = poses[2 + i]
        gt.append(-Tg[:3, :3].T @ Tg[:3, 3])
    ate = j_ate_rmse(np.asarray(est), np.asarray(gt), with_scale=True)
    gt_arr = np.asarray(gt)
    path = float(np.sum(np.linalg.norm(np.diff(gt_arr, axis=0), axis=-1)))
    assert res["failed_frames"] == oks.count(False)
    assert res["keyframes"] == n_kf == n_chunks * SUPERSTEPS
    np.testing.assert_allclose([res["ate_m"], res["path_m"], res["drift"]], [ate, path, ate / max(path, 1e-9)],
                               rtol=1e-12, atol=0)
    want_broken = not (ate / path < 0.015 and ate < 0.10) or oks.count(False) > 0
    assert (res["broken"] is not None) == want_broken


def test_multiseq_bench_matches_jax():
    """``bench_multiseq_torch``'s ``bootstrap`` and ``run`` at S = 2 (one
    warm-up chunk and one timed chunk of one superstep) against the JAX
    ``multi_chunk_fn`` from the JAX bootstrap of each sequence on the same
    chunks: ``ok`` and ``is_kf`` equal, centres within 2 % of each
    sequence's path: ``test_torch_multi_seq``'s band against JAX, over its
    8 frames (beyond them the LMs and the BA carry the rounding of the
    vmapped ops to several % of this short path, as that file says); the
    aggregate is S times the per-sequence frames/s."""
    supersteps = 1
    n = supersteps * PER
    seqs = [_frames(seed, 2 + 2 * n)[0] for seed in (7, 100)]  # test_torch_multi_seq's scenes
    jsubs, uniforms = [], []
    for frames in seqs:
        jds = _jax_system()
        uniforms.append(_uniforms(jds, frames[0]))
        jds.add_image(frames[1], 1.0)
        jsubs.append(jds)
    draws = iter(uniforms)
    subs = bench_multiseq_torch.bootstrap(seqs, lambda: _system(next(draws)))
    assert [k for _, k in subs] == [2, 2]
    res = bench_multiseq_torch.run(subs, seqs, supersteps, 1)
    assert res["sequences"] == 2 and res["per_seq_fps"] * 2 == res["value"]
    assert len(res["chunk_s"]) == 1 and res["broken"] is None and res["ok_warmup"] == res["ok_last"] == 1.0

    fn, state = j_multi_chunk_fn(jsubs[0].vo), j_stack_states([j.state for j in jsubs])
    c_boots = [_c_boot(jax.device_get(j.state)) for j in jsubs]
    j_outs = []
    for c in range(len(res["outs"])):
        imgs = np.stack([np.stack(s[2 + c * n:2 + (c + 1) * n]) for s in seqs])
        imgs = imgs.reshape(2, supersteps, PER, *seqs[0][0].shape).transpose(1, 0, 2, 3, 4)
        state, j_out = fn(state, jnp.asarray(imgs))
        j_outs.append(jax.device_get(j_out))
    for i, c_boot in enumerate(c_boots):
        def pick(outs):  # sequence i's frames of every chunk
            return type(outs[0])(*[np.concatenate([np.asarray(o[f])[:, i] for o in outs])
                                   for f in range(len(outs[0]))])
        _hold_to_jax(pick(res["outs"]), pick(j_outs), c_boot)


def _small_state():
    """A port ``DeviceSystem`` on the small scene (chunks of one superstep),
    bootstrapped and one superstep on, with the next superstep's frames and
    the current image after it."""
    frames, _ = _frames(7, 2 + 2 * PER)
    ds = DeviceSystem(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM), device="cpu",
                      **dict(KW, supersteps_per_chunk=1))
    ds.add_image(frames[0], 0.0)
    ds.add_image(frames[1], 1.0)
    first = torch.from_numpy(np.stack(frames[2:2 + PER])[None])
    ds.state, _ = ds.vo.chunk_fn(1)(ds.state, first)
    return ds, torch.from_numpy(np.stack(frames[2 + PER:])[None]), torch.from_numpy(frames[2 + PER])


def _same_bits(a, b):
    la, lb = jax.tree_util.tree_leaves(to_numpy(a)), jax.tree_util.tree_leaves(to_numpy(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(np.ascontiguousarray(x).reshape(-1).view(np.uint8),
                                      np.ascontiguousarray(y).reshape(-1).view(np.uint8))


def test_profile_system_stages_are_the_frame_step():
    """Each stage callable of ``profile_system_torch`` gives bit for bit what
    the port's ``_frame_step`` computed at that stage from the same state
    (its outputs recorded here, in the frame step itself), the two whole
    frames are ``_frame_step``'s, the recording leaves the package as it
    was, and ``profile`` times every stage and the chain on the CPU."""
    from sdvo_tpu_torch.align.image_alignment import SparseImageAlign
    from sdvo_tpu_torch.pipeline import device_system as D

    ds, _, image = _small_state()
    vo, state = ds.vo, ds.state
    spied = {"pyramid": (D, "build_pyramid"), "alignment (K1 x4)": (SparseImageAlign, "align_precomputed"),
             "reprojection (K2)": (D, "reproject_device"), "pose polish (K3)": (D, "pose_refine"),
             "depth filters (K4)": (D, "update_filters"), "local BA": (D.DeviceVO, "_run_ba")}
    before = {name: vars(ns)[attr] for name, (ns, attr) in spied.items()}
    stages = profile_system_torch.record_stages(vo, state, image)
    assert {name: vars(ns)[attr] for name, (ns, attr) in spied.items()} == before
    assert list(stages) == list(spied) + ["tracked frame", "keyframe frame"]

    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(name, out)
            return out
        return wrapped

    try:
        for name, (ns, attr) in spied.items():
            setattr(ns, attr, spy(name, before[name]))
        frame_kf = vo._frame_step(state, image, is_kf=True)
    finally:
        for name, (ns, attr) in spied.items():
            setattr(ns, attr, before[name])
    frame_track = vo._frame_step(state, image, is_kf=False)
    seen.update({"tracked frame": frame_track, "keyframe frame": frame_kf})
    for name, (fn, args, kwargs) in stages.items():
        _same_bits(fn(*args, **kwargs), seen[name])

    rows = profile_system_torch.profile(vo, state, image, reps=2, replays=1)
    assert [r["stage"] for r in rows] == ["chain alone"] + list(stages)
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 and "kernels" not in r for r in rows)
    assert profile_system_torch.amortized(rows, PER) > 0


def test_profile_ablate_leaves_the_port_as_it_was():
    """After ``profile_ablate_torch``'s ablations (the CPU, one superstep), a
    fresh ``DeviceVO`` gives the bits it gave before them, and every stubbed
    function is the original again; each ablation ran."""
    ds, imgs, _ = _small_state()
    vo, state = ds.vo, ds.state
    targets = [t for ts in profile_ablate_torch.ablations().values() for t in ts]
    originals = [vars(ns)[attr] for ns, attr, _ in targets]

    def fresh_chunk():
        return DeviceVO(vo.cam, vo.cfg, align_settings=vo.aligner.settings, dtype=vo.dtype,
                        chunk_supersteps=1).chunk_fn(1)(state, imgs)

    want = fresh_chunk()
    rows = profile_ablate_torch.run_ablations(vo, state, imgs, 1, replays=1)
    assert [vars(ns)[attr] for ns, attr, _ in targets] == originals
    _same_bits(fresh_chunk(), want)
    assert [r["run"] for r in rows] == ["full chunk"] + list(profile_ablate_torch.ablations())
    assert all(np.isfinite(r["ms_frame"]) and r["ms_frame"] > 0 for r in rows) and rows[0]["delta_ms_frame"] == 0


def test_entry_points_import_without_jax_and_want_the_card():
    """The four entry points import where neither JAX nor the JAX package
    can be imported, and each, run without ``--device cpu`` where there is
    no card, exits non-zero with ``resolve_device``'s message."""
    block = "import sys; sys.modules['jax'] = None; sys.modules['sdvo_tpu'] = None; "
    code = block + f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tools')!r}]; " + \
        "import bench_torch, bench_multiseq_torch, profile_system_torch, profile_ablate_torch, chip_smoke"
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", block + "import runpy; sys.argv = [sys.argv[1]]; "
                               "runpy.run_path(sys.argv[0], run_name='__main__')", os.path.join(ROOT, p)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for p in ENTRY_POINTS]
    for path, proc in zip(ENTRY_POINTS, procs):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode != 0 and not out, (path, out)
        assert "no CUDA device: the port runs on the card by default" in err, (path, err[-2000:])


def test_proxy_builds_and_its_line_is_read(tmp_path):
    """``tools/ref_proxy_bench.cpp`` builds with the compile line of its
    header into a directory of its own, and one run's last line gives the
    frames/s (a run takes about a second of one CPU core); a line of another
    metric is refused."""
    exe = bench_torch.build_proxy(str(tmp_path))
    assert exe.startswith(str(tmp_path)) and bench_torch.build_proxy(str(tmp_path)) == exe
    (fps,) = bench_torch.run_proxy(exe, runs=1)
    assert np.isfinite(fps) and fps > 0
    assert bench_torch.proxy_fps('noise\n{"metric": "cpu_proxy_fps", "value": 49.9}\n') == 49.9
    with pytest.raises(ValueError):
        bench_torch.proxy_fps('{"metric": "other", "value": 1.0}')
