"""The port's chunks hold nothing a CUDA graph cannot capture, checked on
the CPU.

On the card ``DeviceVO.run_chunk``, ``StreamingTracker.track_chunk`` and the
multi-sequence chunk run as CUDA graphs (``pipeline.cuda_graph``). A captured
region may not read a device value on the host, choose a shape from data, or
copy host data to the device; on the card such an op makes the capture fail
(or, for a copy made once, bakes in a stale value). ``CaptureGuard`` raises
on every op of that kind that a step dispatches:

* a host read: ``aten._local_scalar_dense`` (``.item()``, ``bool(t)``,
  ``int(t)``, indexing with a 0-d tensor);
* a data-dependent shape: ``nonzero``, ``masked_select``, ``unique*``,
  ``repeat_interleave.Tensor``, and indexing or ``index_put`` with a boolean
  mask;
* a tensor built from Python or numpy data: ``aten.lift_fresh`` (how
  ``torch.tensor``, ``torch.as_tensor`` and ``torch.from_numpy`` dispatch).

Each step runs once unguarded first, as ``GraphedCall`` warms a graph up
before capturing it: constants built once and cached (``device.constant``,
``depth.filter._px_error_angle``) are built there, outside the graph.

The scenes are small: the 320×240 ridge of ``test_pipeline_e2e`` with
``test_torch_device_system``'s configuration, and the streaming test's
160×120 plane.
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from sdvo_tpu_torch.align.image_alignment import AlignFeatures, SparseImageAlign
from sdvo_tpu_torch.config import load_config
from sdvo_tpu_torch.dataio.synthetic import render_plane_track
from sdvo_tpu_torch.depth import epipolar
from sdvo_tpu_torch.depth.filter import _px_error_angle, init_filters
from sdvo_tpu_torch.geometry import se3
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.image.interp import extract_patches
from sdvo_tpu_torch.image.pyramid import _PYRDOWN_TAPS, build_pyramid, pyr_down
from sdvo_tpu_torch.ops.lm_align import bin_median
from sdvo_tpu_torch.parallel import stack_states
from sdvo_tpu_torch.pipeline.cuda_graph import flatten, unflatten
from sdvo_tpu_torch.pipeline.device_system import DeviceSystem
from sdvo_tpu_torch.pipeline.streaming import StreamCarry, StreamingTracker

from test_pipeline_e2e import CAM, make_sequence
from test_torch_device_system import KW, OVERRIDES

torch.set_num_threads(2)

_PORT = os.path.dirname(os.path.abspath(__import__("sdvo_tpu_torch").__file__))


class CaptureHazard(AssertionError):
    pass


def _hazard(func, args) -> bool:
    name = func.overloadpacket.__name__
    if name in ("_local_scalar_dense", "nonzero", "masked_select", "lift_fresh", "lift_fresh_copy"):
        return True
    if "unique" in name:
        return True
    if name == "repeat_interleave":
        return func._overloadname == "Tensor"
    if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
        indices = args[1] if len(args) > 1 else ()
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in indices)
    return False


class CaptureGuard(TorchDispatchMode):
    """Raises ``CaptureHazard`` on the first op a CUDA graph cannot hold,
    naming it and the line of the port that issued it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _hazard(func, args):
            import traceback

            port = [f for f in traceback.extract_stack() if f.filename.startswith(_PORT)]
            where = f"{os.path.relpath(port[-1].filename, os.path.dirname(_PORT))}:{port[-1].lineno}" if port else "?"
            raise CaptureHazard(f"{func} at {where}")
        return func(*args, **(kwargs or {}))


def _guarded(step):
    step()  # the warm-up: what a graph's capture also runs first
    with CaptureGuard():
        return step()


@functools.lru_cache(maxsize=None)
def _bootstrapped():
    """A ``DeviceSystem`` on the CPU after its two-frame bootstrap, and the
    next superstep's three frames."""
    _, images, _ = make_sequence(np.random.default_rng(7), n_frames=5)
    frames = [np.asarray(im, np.float32) for im in images]
    ds = DeviceSystem(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM), device="cpu", **KW)
    ds.add_image(frames[0], 0.0)
    ds.add_image(frames[1], 1.0)
    assert ds.bootstrapped
    return ds, torch.from_numpy(np.stack(frames[2:5]))


def _streaming_step():
    """One ``StreamingTracker._frame_step`` on the streaming test's scene:
    64 features, 32 matched, 16 filters, three levels."""
    cam = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
    sc = render_plane_track(np.random.default_rng(42), cam, [0.08, 0.01, 0.05, 0.001, 0.004, 0.0008], 1, 64, 16)
    pyr = build_pyramid(torch.from_numpy(sc.ref), 3)
    feats = AlignFeatures(torch.from_numpy(sc.uv), torch.zeros(64, dtype=torch.int32),
                          torch.from_numpy(sc.points), torch.ones(64, dtype=torch.bool))
    patches, ok = extract_patches(pyr.base_image, torch.from_numpy(sc.filter_uv), 7)
    bank = init_filters(torch.from_numpy(sc.filter_uv), torch.from_numpy(sc.filter_bearing), patches, 0, 9.0, 4.0,
                        0, ok)
    tracker = StreamingTracker(SparseImageAlign(patch_size=5, min_level=0, max_level=2), levels=3, device="cpu")
    eye = se3.SE3.identity()
    carry = StreamCarry(eye, eye, bank)
    image = torch.from_numpy(sc.frames[0])
    return lambda: tracker._frame_step(carry, image, [im[None] for im in pyr.images], pyr.base_gradient, feats,
                                       feats.uv_host[:32], torch.ones(32, dtype=torch.bool), cam["fx"], cam["fy"],
                                       cam["cx"], cam["cy"], torch.zeros((), dtype=torch.int32))


def _superstep():
    ds, images = _bootstrapped()
    return lambda: ds.vo.superstep(ds.state, images)


def _vmapped_superstep():
    """The multi-sequence path's step: ``torch.func.vmap`` of the superstep
    over S = 2 copies of the bootstrapped state."""
    ds, images = _bootstrapped()
    state = stack_states([ds.state, ds.state])
    return lambda: torch.func.vmap(ds.vo.superstep)(state, torch.stack([images, images]))


STEPS = {"superstep": _superstep, "streaming_frame_step": _streaming_step,
         "vmapped_superstep": _vmapped_superstep}


@pytest.mark.parametrize("step", sorted(STEPS))
def test_step_holds_no_capture_hazard(step):
    """One superstep (its last frame a keyframe: promotion, re-detection,
    the windowed BA, eviction), one streaming frame step and one vmapped
    superstep at S = 2 dispatch no op the guard refuses, the kernels' plain
    versions included."""
    out = _guarded(STEPS[step]())
    leaves, _ = flatten(out)
    assert leaves and all(torch.isfinite(x).all() for x in leaves if x.is_floating_point())


def _pyr_down_before(image):
    """``image.pyramid.pyr_down`` as it stood before its taps became a cached
    constant: a tensor built from a Python list on every call."""
    k = torch.tensor(_PYRDOWN_TAPS, dtype=image.dtype, device=image.device)
    x = F.pad(image[None, None], (2, 2, 2, 2), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, 5, 1), stride=(2, 1))
    return F.conv2d(x, k.view(1, 1, 1, 5), stride=(1, 2))[0, 0]


_X = torch.arange(12, dtype=torch.float32).reshape(3, 4)
_REPEATS = torch.tensor([1, 2, 0, 1])
HAZARDS = {
    "pyr_down_before": (lambda: _pyr_down_before(_X), "lift_fresh"),
    "item": (lambda: _X.sum().item(), "_local_scalar_dense"),
    "bool_of_tensor": (lambda: bool((_X > 3).any()), "_local_scalar_dense"),
    "index_by_0d_tensor": (lambda: _X[torch.argmax(_X[:, 0])], "_local_scalar_dense"),
    "nonzero": (lambda: torch.nonzero(_X > 3), "nonzero"),
    "boolean_mask": (lambda: _X[_X > 3], "index"),
    "masked_select": (lambda: torch.masked_select(_X, _X > 3), "masked_select"),
    "unique": (lambda: torch.unique(_X), "unique"),
    "repeat_interleave_tensor": (lambda: torch.repeat_interleave(_X[0], _REPEATS),
                                 "repeat_interleave"),
    "as_tensor_of_numpy": (lambda: torch.as_tensor(np.ones(3, np.float32)) + _X[0, :3], "lift_fresh"),
}


@pytest.mark.parametrize("case", sorted(HAZARDS))
def test_guard_fires(case):
    """The guard is no blind spot: it refuses each kind of op, among them
    ``pyr_down`` as it stood before its taps were cached; and it names the
    op."""
    fn, op = HAZARDS[case]
    with pytest.raises(CaptureHazard, match=op):
        _guarded(fn)


def test_guard_passes_the_capture_safe_forms():
    """What the port writes instead: a cached constant, a fill from a Python
    scalar, a device-side index, ``repeat_interleave`` by an int."""
    def step():
        k = torch.argmax(_X[:, 0]).reshape(1)
        return (pyr_down(_X), torch.full((), 1e-2), _X.index_select(0, k)[0],
                torch.repeat_interleave(_X[0], 3), torch.where(_X > 3, _X, 0.0))

    _guarded(step)


def _affine_warp_before(T, uv, depth, fx, fy, cx, cy, half_patch):
    """``depth.epipolar.affine_warp_matrix`` as it stood before its offsets
    became cached constants."""
    def backproject(p):
        b = torch.stack([(p[..., 0] - cx) / fx, (p[..., 1] - cy) / fy, torch.ones_like(p[..., 0])], dim=-1)
        return b / torch.linalg.norm(b, dim=-1, keepdim=True)

    h = float(half_patch)
    du = torch.tensor([h, 0.0], dtype=uv.dtype)
    dv = torch.tensor([0.0, h], dtype=uv.dtype)
    c_c = epipolar._project(T.apply(backproject(uv) * depth[:, None]), fx, fy, cx, cy)
    c_u = epipolar._project(T.apply(backproject(uv + du) * depth[:, None]), fx, fy, cx, cy)
    c_v = epipolar._project(T.apply(backproject(uv + dv) * depth[:, None]), fx, fy, cx, cy)
    return torch.stack([(c_u - c_c) / h, (c_v - c_c) / h], dim=-1)


def _bin_median_before(x, vis, lo, hi, half_n, stages=2):
    """``ops.lm_align.bin_median`` as it stood before its bin was picked on
    the device (indexing with a 0-d tensor reads it on the host)."""
    bins = 16
    b = torch.arange(bins, dtype=x.dtype)
    xf, vf = x.reshape(-1), vis.reshape(-1)
    med = hi
    for _ in range(stages):
        span = torch.clamp(hi - lo, min=1e-12)
        thr = lo + ((b + 1.0) / bins) * span
        cnts = torch.where(xf[None, :] <= thr[:, None], vf[None, :], 0.0).sum(-1)
        prev = torch.cat([cnts.new_zeros(1), cnts[:-1]])
        hit = (prev < half_n) & (cnts >= half_n)
        any_hit = hit.any()
        k = torch.argmax(hit.to(torch.int32))
        frac = (half_n - prev[k]) / torch.clamp(cnts[k] - prev[k], min=1.0)
        kf = b[k]
        med = torch.where(any_hit, lo + (kf + frac) * (span / bins), med)
        lo, hi = torch.where(any_hit, lo + kf * (span / bins), lo), torch.where(any_hit, lo + (kf + 1.0) * (span / bins), hi)
    return med


def _rewrite_pairs():
    g = np.random.default_rng(3)
    img = torch.from_numpy((255 * g.random((61, 83))).astype(np.float32))
    T = se3.exp(torch.from_numpy(g.normal(0, 0.05, 6).astype(np.float32)))
    uv = torch.from_numpy(g.uniform(10, 70, (40, 2)).astype(np.float32))
    depth = torch.from_numpy(g.uniform(4, 20, 40).astype(np.float32))
    r = torch.from_numpy(g.normal(0, 3, 300).astype(np.float32))
    vis = torch.from_numpy((g.random(300) < 0.8).astype(np.float32))
    lo, hi, half = r.min(), r.max(), 0.5 * vis.sum()
    cam = (320.0, 321.0, 40.5, 30.25)
    return {
        "pyr_down": (lambda: pyr_down(img), lambda: _pyr_down_before(img)),
        "pyr_down_float64": (lambda: pyr_down(img.double()), lambda: _pyr_down_before(img.double())),
        "affine_warp_matrix": (lambda: epipolar.affine_warp_matrix(T, uv, depth, *cam, 3),
                               lambda: _affine_warp_before(T, uv, depth, *cam, 3)),
        "bin_median": (lambda: bin_median(r, vis, lo, hi, half), lambda: _bin_median_before(r, vis, lo, hi, half)),
        "px_error_angle": (lambda: torch.tensor(_px_error_angle(721.5377, torch.float32)),
                           lambda: torch.tensor(float(torch.arctan(torch.tensor(1.0 / (2.0 * 721.5377),
                                                                                dtype=torch.float32))) * 2.0)),
    }


@pytest.mark.parametrize("case", ["pyr_down", "pyr_down_float64", "affine_warp_matrix", "bin_median",
                                  "px_error_angle"])
def test_capture_safe_rewrites_keep_every_bit(case):
    """Each rewrite made for capture computes the same bits as the form it
    replaced."""
    new, old = _rewrite_pairs()[case]
    a, b = new(), old()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(-1).view(torch.uint8), b.contiguous().view(-1).view(torch.uint8)), case


def test_superstep_keeps_the_state_signature():
    """A superstep hands back a state of the structure, shapes and types it
    was given (the state ``_pack`` builds), so that one captured chunk serves
    every chunk of a run, a re-packed state after relocalization included."""
    ds, images = _bootstrapped()
    state, out = ds.vo.superstep(ds.state, images)
    assert flatten(state)[1] == flatten(ds.state)[1]
    assert all(x.shape[:1] == (3,) for x in out)


def test_tree_round_trip_and_spec():
    """``flatten``/``unflatten`` give back the state leaf for leaf; the spec
    tells a state of other capacities apart."""
    ds, _ = _bootstrapped()
    leaves, spec = flatten(ds.state)
    back = unflatten(spec, leaves)
    assert type(back) is type(ds.state) and all(a is b for a, b in zip(flatten(back)[0], leaves))
    other = ds.state._replace(frame_id=ds.state.frame_id.to(torch.int64))
    assert flatten(other)[1] != spec


def test_run_chunk_on_the_cpu_is_the_eager_loop():
    """On the CPU ``run_chunk`` is the Python loop (``run_chunk_eager``): the
    same bits, and no graph made."""
    ds, images = _bootstrapped()
    chunk = images[None]
    a = ds.vo.run_chunk(ds.state, chunk)
    b = ds.vo.run_chunk_eager(ds.state, chunk)
    for x, y in zip(flatten(a)[0], flatten(b)[0]):
        assert torch.equal(x, y)
    assert ds.vo.chunk_graph.graphs == {} and ds.vo.step_graph.graphs == {}


def test_capture_error_names_the_line_of_the_port():
    """A capture that fails says where: the innermost line of the port in the
    traceback of the error or of the error it was raised during."""
    from sdvo_tpu_torch.ops import build
    from sdvo_tpu_torch.pipeline.cuda_graph import _where

    try:
        try:
            build.check(700, "a kernel")
        except RuntimeError:
            raise RuntimeError("the capture was invalidated")
    except RuntimeError as err:
        where = _where(err)
    assert where.startswith("sdvo_tpu_torch/ops/build.py:") and "raise RuntimeError" in where, where


def test_graphed_call_refuses_inputs_off_its_card():
    """``GraphedCall`` checks every input's device before anything reaches
    the card: a CPU tensor is refused, not copied over."""
    from sdvo_tpu_torch.pipeline.cuda_graph import GraphedCall

    call = GraphedCall(lambda x: x + 1, "plus-one")
    with pytest.raises(ValueError, match=r"plus-one: the inputs lie on \['cpu'\], not on one CUDA card"):
        call(torch.zeros(3))
    assert call.graphs == {} and call.last is None


def test_graph_key_holds_the_mode():
    """A graph's key holds the settings that decide which kernels a capture
    records: the deterministic mode the port ships in and PyTorch's default
    give different keys, and leaving the mode gives the first key back."""
    from sdvo_tpu_torch.device import deterministic_algorithms
    from sdvo_tpu_torch.pipeline.cuda_graph import mode

    outside = mode()
    with deterministic_algorithms():
        inside = mode()
    assert inside != outside and mode() == outside
    assert inside[0] is True and outside[0] is torch.are_deterministic_algorithms_enabled()
