"""The trace's reduction on a synthetic trace: the union of kernel
intervals, the idle share, the breakdown, and each kernel's roofline share;
the frozen bound against the port's own ``selfcheck.bound_ms`` today."""

from types import SimpleNamespace

import pytest

from benchmark.harness import roofline, spec
from benchmark.harness.trace import Slice, idle_gaps, union_seconds


def test_union_counts_overlaps_once():
    assert union_seconds([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]) == pytest.approx(3.0)
    assert union_seconds([]) == 0.0
    assert idle_gaps([(1.0, 2.0), (1.5, 3.0)], 0.0, 4.0) == [(0.0, 1.0), (3.0, 4.0)]


def synthetic():
    kernels = [("lm_align_level_kernel", 0.000, 0.004), ("aten::add", 0.003, 0.005),
               ("depth_scores_kernel", 0.006, 0.007), ("lm_align_level_kernel", 0.009, 0.010)]
    ranges = [("slice", 0.0, 0.012), ("add_image", 0.0045, 0.0095)]
    return Slice.from_intervals(kernels, ranges, lo=0.0, hi=0.012, frames=3, supersteps=1)


def test_idle_share_and_breakdown():
    s = synthetic()
    assert s.busy_s == pytest.approx(0.007)
    assert s.idle_share() == pytest.approx(1 - 0.007 / 0.012)
    b = s.breakdown()
    assert b["device_ops"][0] == ["lm_align_level_kernel", pytest.approx(0.005)]
    gaps = b["idle_gaps"]
    assert sorted((g[0], round(g[1], 9)) for g in gaps) == [("add_image", 0.001), ("add_image", 0.002),
                                                              ("harness", 0.002)]
    assert gaps[-1][1] == pytest.approx(0.001)  # longest first


def test_readers_on_the_synthetic_trace():
    s = synthetic()
    calls = {"lm_align_level": [{"shapes": {"N": 256, "WH": 16, "WW": 32, "P2": 25, "frozen": 0},
                                 "iterations": 10, "patch": 5}],
             "depth_scores": [{"shapes": {"N": 8192, "WH": 16, "WW": 32, "P2": 49, "steps": 16},
                               "iterations": 0, "patch": 7}]}
    run = SimpleNamespace(system="device_system", slice=s, launches=calls, capture_s=8.5, frames=3,
                          supersteps=1, window_s=1.0, add_image_s=0.5, run_chunk_s=0.2, chunk_fn_s=0.0)
    got = spec.read_metrics(spec.benchmark()["per_layer"], run)
    least = roofline.launch_bound("lm_align_level", calls["lm_align_level"][0]).ms * 1e-3
    assert got["lm_align_level_roofline"]["value"] == pytest.approx(100 * 2 * least / 0.005)
    assert got["lm_align_level_roofline"]["unit"] == "%"
    assert 0 < got["depth_scores_roofline"]["value"] < 100
    assert "fa_align_batch_roofline" not in got and "pose_refine_roofline" not in got  # nothing to read
    assert got["device.idle_share"]["value"] == pytest.approx(1 - 0.007 / 0.012)
    assert got["device_vo.kernels_per_frame"]["value"] == pytest.approx(4 / 3)
    assert got["device_vo.device_ms_per_frame"]["value"] == pytest.approx(7 / 3)
    assert got["kernels.device_ms_per_frame"]["value"] == pytest.approx(6 / 3)
    assert got["device_system.host_ms_per_frame"]["value"] == pytest.approx(100.0)
    assert got["graph.capture_s"]["value"] == 8.5
    assert "multi_seq.host_share" not in got


@pytest.mark.parametrize("name,shapes,its", [
    ("lm_align_level", {"N": 256, "WH": 16, "WW": 32, "P2": 25}, 10),
    ("lm_align_level", {"N": 256, "WH": 16, "WW": 32, "P2": 25, "frozen": 1}, 4),
    ("fa_align_batch", {"N": 150, "WH": 16, "WW": 32, "P2": 25}, None),
    ("pose_refine", {"N": 150}, 8),
    ("depth_scores", {"N": 8192, "WH": 16, "WW": 32, "P2": 49, "win_bytes": 2 ** 21, "steps": 16}, None),
])
def test_the_frozen_bound_is_selfchecks(name, shapes, its):
    from sdvo_tpu_torch.ops import selfcheck

    assert tuple(roofline.bound_ms(name, shapes, its)) == tuple(selfcheck.bound_ms(name, shapes, its))
