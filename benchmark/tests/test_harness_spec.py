"""The benchmark's data found by name: BENCHMARK.json against the contract's
shape, every configuration, cell and metric file present, and a new cell
taken from its files alone."""

import json
import os
import re
import shutil

import pytest

from benchmark.harness import spec
from benchmark.harness import check
from benchmark.harness.check import NUMBERS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    # a full check of 24 cells still fits its 43,200 s at this run length
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert cells <= 24 and len(json.dumps(bench)) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_metrics_are_well_formed(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for c in m["workloads"]:
            assert c in cells and spec.applies(e2e[m["moves"]], c), (m["name"], c)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert sum(spec.applies(m, c) for m in bench["end_to_end"]) >= 2
        assert any(spec.applies(m, c) for m in bench["per_layer"])


def test_every_file_is_found_by_name(bench):
    for c in bench["configs"]:
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        assert cell.traffic["traffic"] == w["traffic"] and w["chips"] == 1
        assert set(check.limits(cell)) == set(NUMBERS)  # the traffic's limits and the configuration's drift
        assert len(w["why"]) <= 200
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_cell_added_as_files_alone(bench, tmp_path):
    """A later cell needs its traffic file and its entry: the harness finds
    them with no edit."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    new = dict(json.loads((root / "benchmark" / "workloads" / "kitti_mono.offline.json").read_text()),
               supersteps_per_chunk=8)
    (root / "benchmark" / "workloads" / "kitti_mono.offline8.json").write_text(json.dumps(new))
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "kitti_mono.offline8", "config": "kitti_mono", "traffic": "offline8",
                           "chips": 1, "why": "chunks of 8 supersteps"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.Cell(spec.benchmark(str(root)), "kitti_mono.offline8", str(root / "benchmark"))
    assert cell.traffic["supersteps_per_chunk"] == 8 and cell.system == "device_system"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]  # frames_per_s lists its cells
    with pytest.raises(KeyError):
        spec.Cell(bench, "no_such.cell")


def test_a_reader_that_finds_nothing_leaves_its_metric_out(bench):
    from types import SimpleNamespace

    run = SimpleNamespace(system="device_system", slice=None, launches=None, capture_s=None, frames=0,
                          supersteps=0, window_s=0.0, add_image_s=0.0, run_chunk_s=0.0, chunk_fn_s=0.0)
    assert spec.read_metrics(bench["per_layer"], run) == {}


def test_a_configuration_is_read_whole(bench, tmp_path):
    """The harness reads a configuration's camera, scene and reference from
    its file; a file whose settings state another image size than its
    camera's is refused."""
    cell = spec.Cell(bench, "kitti_mono.offline")
    assert cell.reference == spec.DEFAULT_REFERENCE == "benchmark.reference"
    assert {"system", "n_seq", "camera", "scene", "settings"} <= set(cell.config)
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "benchmark" / "configs" / "kitti_mono.json").read_text())
    for key, value, error in (("reference", "benchmark.tests.planted_reference", None),
                              ("camera", {**cfg["camera"], "width": 1240}, ValueError)):
        (root / "benchmark" / "configs" / "kitti_mono.json").write_text(json.dumps({**cfg, key: value}))
        if error is None:
            assert spec.Cell(bench, "kitti_mono.offline", str(root / "benchmark")).reference == value
        else:
            with pytest.raises(error, match="settings.camera is 1241x376, its camera 1240x376"):
                spec.Cell(bench, "kitti_mono.offline", str(root / "benchmark"))
