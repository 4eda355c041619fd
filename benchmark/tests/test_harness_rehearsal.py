"""The CPU rehearsal: whole runs of the cells through the harness at half
KITTI size on the CPU (the port's kernels' plain versions, the systems'
eager loops), the count over whole dispatches and the tail over every
sample, the control's readings against the committed limits, and each fault
a cell can have, planted under the timed path: ``correct`` must come out
false. ``run.py`` itself never runs on the CPU."""

import time

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.harness import check, drive, spec

KITTI = spec.load_json(f"{spec.BENCH_DIR}/configs/kitti_mono.json")["camera"]
CAM = scene.camera(KITTI, 0.5)
TEX = 1024
SEED = 2 ** 31 + 11
# two streams bootstrap in one call: at half size one of these textures finds
# too few inliers in 30 frames, so the joint rehearsal runs at 3/4 size
CAM_X8, TEX_X8 = scene.camera(KITTI, 0.75), 2048


def cell(name, n_seq=None, **traffic):
    c = spec.Cell(spec.benchmark(), name)
    c.traffic = {**c.traffic, **traffic}
    if n_seq is not None:
        c.config = {**c.config, "n_seq": n_seq}
    return c


def measure(c, seconds=0.1, fault=None, seed=SEED, cam=CAM, tex=TEX):
    import run

    return run.measure(c, seed, seconds, False, "cpu", time.perf_counter(), cam=cam, texture_size=tex,
                       fault=fault, log=lambda *a, **k: None)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    import sys

    sys.path.insert(0, spec.BENCH_DIR)
    was = torch.get_num_threads()
    torch.set_num_threads(min(4, was))
    yield
    torch.set_num_threads(was)


def test_a_window_is_whole_dispatches():
    c = cell("kitti_mono.offline", supersteps_per_chunk=2)
    w = drive.run_window(c, SEED, 1.0, False, "cpu", cam=CAM, texture_size=TEX)
    per_dispatch = 2 * w.period
    assert w.frames > 0 and w.frames % per_dispatch == 0
    assert len(w.latency_s) == w.frames // per_dispatch  # one sample a dispatch
    assert w.t_end - w.t0 >= 1.0 > w.t_end - w.t0 - max(w.latency_s)  # ends with the first dispatch past it
    assert w.window_frames == [(len(w.trajectories[0]) - w.frames, len(w.trajectories[0]))]


def test_the_rate_and_tail_take_every_sample(monkeypatch):
    import run

    lat = [0.010 + 0.001 * k for k in range(40)]
    w = drive.Window()
    w.t0, w.t_end, w.frames, w.frames_spanned, w.supersteps, w.period, w.streams = 0.0, 2.0, 120, 120, 40, 3, 1
    w.latency_s, w.capture_s, w.slice, w.launches, w.spans = lat, 1.0, None, None, drive.Spans()
    w.marks, w.gc = [(0.05 * (k + 1), 3 * (k + 1)) for k in range(40)], drive.GCWatch()
    w.window_frames, w.trajectories, w.metrics = [(0, 0)], [[]], [[]]
    w.samples, w.starts, w.rings = drive.Reservoir(1, 0), [], []
    monkeypatch.setattr(drive, "run_window", lambda *a, **k: w)
    res = run.measure(cell("kitti_mono.live"), SEED, 2.0, False, "cpu", -3.0, cam=CAM,
                      log=lambda *a, **k: None)
    assert res["metrics"]["pose_latency_p95_ms"]["value"] == pytest.approx(1e3 * np.percentile(lat, 95))
    assert res["metrics"]["setup_s"]["value"] == pytest.approx(3.0)
    assert res["attempted"] == 120 and res["correct"] is False  # nothing compared is not correct


def test_a_rehearsal_run_is_correct():
    res = measure(cell("kitti_mono.live"))
    assert res["correct"] is True, res["check"]
    assert list(res)[-1] == "check" and set(res["metrics"]) == {"pose_latency_p95_ms", "setup_s"}
    assert res["attempted"] % 3 == 0


def test_the_control_is_not_correct():
    import control

    c = cell("kitti_mono.live")
    r = control.readings_for_seed(c, SEED + 1, 0.5, True, "cpu", cam=CAM, texture_size=TEX)
    # the control stands in for the program on the sampled supersteps alone:
    # the numbers against the truth are the program's window's, not its own
    limits = {k: v for k, v in check.limits(c).items() if k not in check.WINDOW}
    assert check.correct(check.judge(r["program"], limits), 1), r["program"]
    assert not check.correct(check.judge(r["control"], limits), 1), r["control"]
    assert not set(check.WINDOW) & set(r["control"])


def _alter(out, frames, **fields):
    """``out`` (a ``FrameOut`` with a trailing period axis) with each named
    field moved by its amount on the frames that ``frames`` (a bool mask of
    the period axis) selects."""
    sel = torch.as_tensor(frames)
    return out._replace(**{k: torch.where(sel, getattr(out, k) + d, getattr(out, k)) if k != "t" else
                           torch.where(sel[..., None], out.t + d, out.t) for k, d in fields.items()})


def _fault_run_chunk(kind):
    def plant(ds):
        real = ds.vo.run_chunk
        per = ds.scfg.period
        kf = [p == per - 1 for p in range(per)]

        def broken(state, images):
            if kind == "state unchanged":
                return state, real(state, images)[1]
            if kind == "half the chunk":  # half the chunk's supersteps left out, the rest repeated
                h = images.shape[0] // 2
                st, out = real(state, images[:h])
                return st, type(out)(*[torch.cat([x] * (images.shape[0] // h)) for x in out])
            st, out = real(state, images)
            if kind == "answer altered":  # every frame's pose and alignment rmse
                return st, _alter(out, [True] * per, t=0.05, rmse=1.0)
            if kind == "a later superstep's frames failed":
                return st, out._replace(ok=torch.cat([out.ok[:-1], torch.zeros_like(out.ok[-1:])]))
            if kind == "a later superstep's keyframe dropped":
                return st, out._replace(is_kf=torch.cat([out.is_kf[:-1], torch.zeros_like(out.is_kf[-1:])]))
            if kind == "keyframes altered":
                return st, _alter(out, kf, t=0.05, rmse=1.0)
            if kind == "tracked frames failed":  # the first frame of every superstep
                return st, out._replace(ok=out.ok & torch.as_tensor([p != 0 for p in range(per)]))
            raise ValueError(kind)

        ds.vo.run_chunk = broken

    return plant


@pytest.mark.parametrize("kind,name,traffic", [
    ("state unchanged", "kitti_mono.live", {}),
    ("answer altered", "kitti_mono.live", {}),
    ("keyframes altered", "kitti_mono.live", {}),
    ("tracked frames failed", "kitti_mono.live", {}),
    ("half the chunk", "kitti_mono.offline", {"supersteps_per_chunk": 2}),
    # past the one superstep of a dispatch that the reference follows: the truth's numbers
    ("a later superstep's frames failed", "kitti_mono.offline", {"supersteps_per_chunk": 3}),
    ("a later superstep's keyframe dropped", "kitti_mono.offline", {"supersteps_per_chunk": 3}),
])
def test_a_fault_under_the_timed_path_is_not_correct(kind, name, traffic):
    res = measure(cell(name, **traffic), seconds=0.5, fault=_fault_run_chunk(kind))
    assert res["correct"] is False, (kind, res["check"])


def _fault_chunk_fn(kind):
    from sdvo_tpu_torch.parallel.mesh import tree_map

    def plant(ms):
        real = ms.chunk_fn

        def broken(state, images):
            if kind == "half the sequences left out":
                h = images.shape[1] // 2
                st, out = real(tree_map(lambda x: x[:h], state), images[:, :h])
                return (tree_map(lambda x: torch.cat([x, x]), st),
                        type(out)(*[torch.cat([x, x], dim=1) for x in out]))
            st, out = real(state, images)  # one sequence's answers altered
            one = torch.zeros(out.rmse.shape[1], dtype=torch.bool)
            one[-1] = True
            return st, out._replace(rmse=torch.where(one[:, None], out.rmse + 1.0, out.rmse))

        ms.chunk_fn = broken

    return plant


def test_a_joint_rehearsal_run_is_correct():
    c = cell("kitti_mono_x8.offline", n_seq=2, supersteps_per_chunk=1)
    assert measure(c, cam=CAM_X8, tex=TEX_X8)["correct"] is True


@pytest.mark.parametrize("kind", ["half the sequences left out", "one sequence altered"])
def test_a_fault_in_the_joint_chunk_is_not_correct(kind):
    c = cell("kitti_mono_x8.offline", n_seq=2, supersteps_per_chunk=1)
    assert measure(c, fault=_fault_chunk_fn(kind), cam=CAM_X8, tex=TEX_X8)["correct"] is False
