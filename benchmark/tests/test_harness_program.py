"""What the harness reads of the port's tracer (``harness/program.py``, the
readers of ``program_metrics.json``, ``trace_program.py``): the stage
matcher on a synthetic replay, a renamed kernel counted as unattributed;
idle gaps put down to program ranges; every new reader None where its span
or counter is absent; the CPU rehearsal reading every metric it can (the
host spans and the counters; the graphs' spans and the device's stages
need the card, and are read here from synthetic records)."""

import os
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import scene
from benchmark.harness import program, spec
from benchmark.harness.trace import Slice

KITTI = spec.load_json(f"{spec.BENCH_DIR}/configs/kitti_mono.json")["camera"]
CAM = scene.camera(KITTI, 0.5)
SEED = 2 ** 31 + 11
STAGE_MAP = (("k_pyr", "device_vo.pyramid"), ("k_lm", "device_vo.align"), ("Memcpy DtoD", "device_vo.align"),
             ("k_stack", ""), ("k_ba", "device_vo.kf.ba"))


def _entries():
    return spec.load_json(os.path.join(spec.BENCH_DIR, "program_metrics.json"))["per_layer"]


@pytest.fixture(scope="module", autouse=True)
def _paths():
    import sys

    sys.path.insert(0, spec.BENCH_DIR)
    was = torch.get_num_threads()
    torch.set_num_threads(min(4, was))
    yield
    torch.set_num_threads(was)


def test_the_matcher_checks_every_name_and_does_not_guess():
    ops = [("k_pyr", 0.0, 1.0), ("k_lm", 1.0, 3.0), ("Memcpy DtoD", 3.0, 3.5), ("k_stack", 3.5, 4.0),
           ("k_ba", 4.0, 8.0)]
    by, lost = program.match_stages(ops, STAGE_MAP)
    assert by == {"device_vo.pyramid": 1.0, "device_vo.align": 2.5, program.OUTSIDE: 0.5, "device_vo.kf.ba": 4.0}
    assert lost == 0.0
    renamed = list(ops)
    renamed[1] = ("k_lm_v2", 1.0, 3.0)  # a kernel the map does not name there
    by, lost = program.match_stages(renamed + [("k_extra", 8.0, 9.0)], STAGE_MAP)
    assert "device_vo.align" in by and by["device_vo.align"] == 0.5 and lost == 3.0  # 2 + the extra 1
    assert sum(by.values()) + lost == pytest.approx(9.0)
    by, lost = program.match_stages(ops, None)  # no map: nothing attributed
    assert by == {} and lost == 8.0
    # two operations that read one start, sorted the other way: those two out, the rest matched after them
    swapped = [ops[0], ops[2], ops[1]] + ops[3:]
    by, lost = program.match_stages(swapped, STAGE_MAP)
    assert lost == 2.5 and by == {"device_vo.pyramid": 1.0, program.OUTSIDE: 0.5, "device_vo.kf.ba": 4.0}
    # an operation the map holds and the replay does not: the match goes on past it
    by, lost = program.match_stages(ops[:2] + ops[3:], STAGE_MAP)
    assert lost == 0.0 and by == {"device_vo.pyramid": 1.0, "device_vo.align": 2.0, program.OUTSIDE: 0.5,
                                  "device_vo.kf.ba": 4.0}


def test_replays_are_matched_to_their_graphs_maps():
    """Every launch of the slice against the map of the one graph the window
    replays: a launch of another graph matches no name there and is
    unattributed; without a map nothing is attributed."""
    ops = [("k_pyr", 5.0, 6.0), ("k_lm", 6.0, 8.0), ("Memcpy DtoD", 8.0, 8.5), ("k_stack", 8.5, 9.0),
           ("k_ba", 9.0, 13.0)]
    launches = [(0.25, ops), (2.5, ops)]
    got = program.replay_stages(launches, STAGE_MAP)
    assert got["replays"] == 2 and got["unattributed"] == 0.0 and got["total"] == pytest.approx(16.0)
    assert got["seconds"]["device_vo.kf.ba"] == 8.0 and got["seconds"]["device_vo.align"] == 5.0
    assert got["attributed"] == pytest.approx(15.0 / 16.0)  # the stack outside every stage is not a stage's
    other = program.replay_stages([(0.25, ops), (2.5, [("k_other", 14.0, 15.0)])], STAGE_MAP)
    assert other["unattributed"] == 1.0 and other["attributed"] == pytest.approx(7.5 / 9.0)
    assert other["unmatched"] == [("k_other", 1.0)] and got["unmatched"] == []
    lost = program.replay_stages(launches, None)
    assert lost["attributed"] == 0.0 and lost["unattributed"] == pytest.approx(16.0)
    assert program.replay_stages([], STAGE_MAP) is None


def test_the_window_replays_the_captures_of_its_system():
    """``graph_captures``: a joint system's chunk graph, else a stream's chunk
    and superstep graphs, each with every capture it holds."""
    a, b, c = object(), object(), object()
    joint = SimpleNamespace(chunk_fn=SimpleNamespace(graph=SimpleNamespace(graphs={1: a})),
                            vo=SimpleNamespace(chunk_graph=SimpleNamespace(graphs={2: b})))
    assert program.graph_captures(joint) == [a]
    stream = SimpleNamespace(vo=SimpleNamespace(chunk_graph=SimpleNamespace(graphs={2: b}),
                                                step_graph=SimpleNamespace(graphs={3: c})))
    assert program.graph_captures(stream) == [b, c]


def test_idle_gaps_are_put_down_to_program_ranges():
    kernels = [("k", 0.0, 1.0), ("k", 4.0, 5.0), ("k", 9.0, 10.0)]
    harness = [("slice", 0.0, 12.0), ("add_image", 3.5, 11.0)]
    s = Slice.from_intervals(kernels, harness, lo=0.0, hi=12.0)
    ranges = [("device_system.dispatch", 5.5, 10.5), ("device_system.emit", 6.0, 6.8),
              ("device_system.buffer", 1.5, 2.0)]
    idle = program.idle_by_span(s, ranges)
    assert idle == pytest.approx({"harness": 3.0, "device_system.buffer": 0.5, "add_image": 1.5,
                                  "device_system.dispatch": 3.2, "device_system.emit": 0.8})
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s)
    gaps = program.idle_gaps_named(s, ranges, top=2)
    assert [g[0] for g in gaps] == ["device_system.dispatch", "harness"]
    assert gaps[0][1] == pytest.approx(4.0)
    mirrored = Slice.from_intervals(kernels + [(program.PREFIX + "device_system.dispatch", 4.0, 10.0)], harness,
                                    lo=0.0, hi=12.0)
    assert program.without_program_ranges(mirrored).kernels == kernels


def _program(**kw):
    base = dict(totals={}, setup={}, counters={}, warmup_s=None, stages=None, idle=None)
    base.update(kw)
    return SimpleNamespace(**base)


def _run(system, p=None, frames=30, sl=None):
    run = SimpleNamespace(system=system, frames=frames, supersteps=frames // 3, window_s=1.0, slice=sl,
                          launches=None, capture_s=None)
    if p is not None:
        run.program = p
    return run


@pytest.mark.parametrize("system", ["device_system", "multi_seq"])
def test_every_new_reader_is_none_without_its_span(system):
    entries = _entries()
    assert len(entries) == 25 and all(spec.reader(m["name"]) for m in entries)
    assert spec.read_metrics(entries, _run(system)) == {}  # a program with no tracer
    assert spec.read_metrics(entries, _run(system, _program())) == {}  # nothing recorded
    sl = Slice.from_intervals([("k", 0.0, 1.0)], [], frames=6, supersteps=2)
    assert spec.read_metrics(entries, _run(system, _program(), sl=sl)) == {}


def test_the_readers_on_a_synthetic_record():
    sl = Slice.from_intervals([("k", 0.0, 1.0)], [], frames=6, supersteps=2)
    stages = {"seconds": {"device_vo.align": 0.003, "device_vo.pyramid": 0.0006, "device_vo.kf.ba": 0.008,
                          "device_vo.kf.detect": 0.002, program.OUTSIDE: 0.0001},
              "unattributed": 0.0, "total": 0.0137, "replays": 1, "attributed": 0.0136 / 0.0137}
    p = _program(totals={"device_system.buffer": (0.06, 30), "device_system.stack": (0.03, 1),
                         "graph.replay": (0.002, 4)},
                 setup={"device_system.bootstrap": (1.5, 2)}, warmup_s=2.5, stages=stages,
                 counters={"device_vo.ba_solves": 1.0, "device_vo.keyframe_steps": 10.0,
                           "lm_align_level.iterations": 90.0, "lm_align_level.launches": 12.0})
    got = {k: v["value"] for k, v in spec.read_metrics(_entries(), _run("device_system", p, sl=sl)).items()}
    assert got["device_system.buffer_ms_per_frame"] == pytest.approx(2.0)
    assert got["device_system.stack_ms_per_frame.live"] == pytest.approx(1.0)
    assert got["device_system.bootstrap_s"] == 1.5 and got["graph.warmup_s"] == 2.5
    assert got["graph.host_ms_per_replay"] == pytest.approx(0.5)
    assert got["device_vo.frame_step_ms_per_frame"] == pytest.approx(3.6 / 6)
    assert got["device_vo.keyframe_step_ms_per_keyframe"] == pytest.approx(10.0 / 2)
    assert got["device_vo.ba_ms_per_keyframe"] == pytest.approx(4.0)
    assert got["device_vo.ba_solve_share"] == pytest.approx(0.1)
    assert got["lm_align_level.iterations_per_launch"] == pytest.approx(7.5)
    assert "pose_refine.iterations_per_launch" not in got and "multi_seq.stack_ms_per_frame" not in got


def test_the_entries_are_benchmark_entries():
    """``program_metrics.json`` holds ``per_layer`` entries of the form
    ``BENCHMARK.json`` takes, in layers it names, each moving an end-to-end
    metric that each of its cells reports, and none already in it."""
    bench = spec.benchmark()
    layers = {m["layer"] for m in bench["per_layer"]}
    names = {m["name"] for m in bench["per_layer"]}
    for m in _entries():
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["layer"] in layers and m["name"] not in names and m["better"] in ("lower", "higher")
        e2e = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert all(spec.applies(e2e, c) for c in m["workloads"]), m["name"]


def _rehearse(name, n_seq=None, cam=CAM, tex=1024, **traffic):
    import trace_program

    from sdvo_tpu_torch.utils.timing import TRACER

    c = spec.Cell(spec.benchmark(), name)
    c.traffic = {**c.traffic, **traffic}
    if n_seq is not None:
        c.config = {**c.config, "n_seq": n_seq}
    res = trace_program.measure(c, SEED, 0.3, False, "cpu", time.perf_counter(), TRACER, cam=cam, texture_size=tex,
                                log=lambda *a, **k: None)
    assert not TRACER.on
    return res


def test_the_rehearsal_reads_the_host_spans_and_counters():
    res = _rehearse("kitti_mono.offline", supersteps_per_chunk=2)
    assert res["correct"] is True, res["check"]
    got = res["program"]
    assert {"device_system.buffer_ms_per_frame", "device_system.stack_ms_per_frame",
            "device_system.copy_in_ms_per_frame", "device_system.emit_ms_per_frame", "device_system.bootstrap_s",
            "device_vo.ba_solve_share", "lm_align_level.iterations_per_launch",
            "pose_refine.iterations_per_launch"} == set(got), got  # no graph and no device on the CPU
    assert 0 <= got["device_vo.ba_solve_share"]["value"] <= 1
    assert 1 <= got["lm_align_level.iterations_per_launch"]["value"] <= 10
    assert 0 <= got["pose_refine.iterations_per_launch"]["value"] <= 8
    spans = res["host_spans"]
    assert spans["device_system.stack"][1] == spans["device_system.dispatch"][1] == spans["device_system.emit"][1]
    assert spans["device_system.buffer"][1] == 6 * spans["device_system.dispatch"][1]
    assert list(res)[-1] == "check"


def test_the_joint_rehearsal_reads_the_host_spans_and_counters():
    res = _rehearse("kitti_mono_x8.offline", n_seq=2, cam=scene.camera(KITTI, 0.75), tex=2048, supersteps_per_chunk=1)
    assert res["correct"] is True, res["check"]
    assert {"multi_seq.stack_ms_per_frame", "multi_seq.copy_in_ms_per_frame", "multi_seq.emit_ms_per_frame",
            "device_system.bootstrap_s", "device_vo.ba_solve_share", "lm_align_level.iterations_per_launch",
            "pose_refine.iterations_per_launch"} == set(res["program"]), res["program"]
