"""Configurations that exist only here, each taken by the harness from its
files alone (a temporary bench directory, never ``BENCHMARK.json``), run
through ``run.measure`` on the CPU: EuRoC MAV cam0's geometry at its 5
pyramid levels, pinhole and through its lens's distortion, and a
configuration that names a reference package of its own."""

import json
import time

import pytest
import torch

from benchmark import scene
from benchmark.harness import spec
from benchmark.tests.test_harness_rehearsal import _fault_run_chunk

SEED = 2 ** 31 + 11
# EuRoC MAV MH_01_easy cam0 (Burri et al., IJRR 2016): 752x480, radial-tangential distortion
EUROC_CAMERA = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480, distortion=[0.0] * 5)
EUROC_DISTORTION = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
# EuRoC's camera at its own size: at 0.5 its 30-pixel cells hold fewer features than the bootstrap's
# 100, at 0.6 and 0.75 the two-view bootstrap finds 24-46 of its 50 inliers or a frame fails to track
EUROC_SCALE, EUROC_TEX = 1.0, 2048
KITTI = spec.load_json(f"{spec.BENCH_DIR}/configs/kitti_mono.json")


def cell_of(tmp_path, name, config, traffic="live"):
    """A cell of ``config`` under a committed traffic file, in a bench
    directory of its own."""
    bench_dir = tmp_path / "benchmark"
    (bench_dir / "configs").mkdir(parents=True)
    (bench_dir / "workloads").mkdir()
    (bench_dir / "configs" / f"{name}.json").write_text(json.dumps({**config, "name": name}))
    (bench_dir / "workloads" / f"{name}.{traffic}.json").write_text(
        json.dumps(spec.load_json(f"{spec.BENCH_DIR}/workloads/kitti_mono.{traffic}.json")))
    committed = spec.benchmark()
    bench = {"configs": [{"name": name, "file": f"benchmark/configs/{name}.json"}],
             "workloads": [{"name": f"{name}.{traffic}", "config": name, "traffic": traffic, "chips": 1}],
             "end_to_end": [{k: v for k, v in m.items() if k != "workloads"} for m in committed["end_to_end"]
                            if m["name"] in ("pose_latency_p95_ms", "setup_s")],
             "per_layer": []}
    return spec.Cell(bench, f"{name}.{traffic}", str(bench_dir))


def euroc(distortion=None):
    """EuRoC cam0's geometry at config/euroc.json's 5 levels, with kitti_mono's
    settings and its two texture overrides, in kitti_mono's scene."""
    settings = {**KITTI["settings"], "camera": {"img_width": 752, "img_height": 480},
                "algorithm": {**KITTI["settings"]["algorithm"], "max_level_image_pyramid": 4}}
    camera = {**EUROC_CAMERA, "distortion": distortion or EUROC_CAMERA["distortion"]}
    return {**KITTI, "camera": camera, "settings": settings}


def measure(c, cam, tex, fault=None, lines=None):
    import run

    def log(*a, **k):
        if lines is not None:
            lines.extend(a)

    return run.measure(c, SEED, 0.5, False, "cpu", time.perf_counter(), cam=cam, texture_size=tex, fault=fault,
                       log=log)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    import sys

    sys.path.insert(0, spec.BENCH_DIR)
    was = torch.get_num_threads()
    torch.set_num_threads(min(4, was))
    yield
    torch.set_num_threads(was)


@pytest.mark.parametrize("fault", [None, "answer altered"])
def test_euroc_geometry_at_five_levels(tmp_path, fault):
    c = cell_of(tmp_path, "euroc_pinhole", euroc())
    cam = scene.camera(c.config["camera"], EUROC_SCALE)
    assert (cam.width, cam.height, c.config["settings"]["algorithm"]["max_level_image_pyramid"]) == (752, 480, 4)
    res = measure(c, cam, EUROC_TEX, fault=None if fault is None else _fault_run_chunk(fault))
    assert res["correct"] is (fault is None), res["check"]


def test_the_reference_key_is_obeyed(tmp_path):
    """kitti_mono's rehearsal with a reference whose rmse is planted one grey
    level high: not correct, by that grey level."""
    c = cell_of(tmp_path, "kitti_planted", {**KITTI, "reference": "benchmark.tests.planted_reference"})
    res = measure(c, scene.camera(c.config["camera"], 0.5), 1024)
    assert res["correct"] is False
    assert res["check"]["rmse_gap_group_median"]["value"] == pytest.approx(1.0, abs=0.05), res["check"]


def test_euroc_through_its_lens(tmp_path):
    """EuRoC cam0 with its distortion: the frames are what the lens sees; the
    port undistorts its bootstrap's frames on the host and its device
    supersteps' not at all, and so does the copied reference, so the check
    runs to its end and its readings are recorded, not judged."""
    c = cell_of(tmp_path, "euroc_lens", euroc(EUROC_DISTORTION))
    lines = []
    res = measure(c, scene.camera(c.config["camera"], EUROC_SCALE), EUROC_TEX, lines=lines)
    print("\n".join(map(str, lines)), "\n", json.dumps(res))
    assert res["attempted"] > 0 and set(res["check"]) >= {"rmse_gap_group_median", "failed_frames"}
