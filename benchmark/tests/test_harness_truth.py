"""The check's numbers against the scene's truth (``check.window_numbers``)
on synthetic windows of the scene's own path: sound, and with a fault in a
minority of the frames or of the streams."""

import numpy as np
import pytest

from benchmark import scene
from benchmark.harness import check, drive, spec

PER, FRAMES, FIRST = 3, 600, 30


def window(streams=2, fault=None):
    """A finished window of ``streams`` streams that track the truth exactly
    (frames ``FIRST``.. in the window), with ``fault(k, trajectory, metrics)``
    applied to each stream."""
    sc = scene.Scene.of(spec.load_json(f"{spec.BENCH_DIR}/configs/kitti_mono.json")["scene"])
    poses = sc.ring_poses()
    ring = scene.Ring(np.zeros((len(poses), 1, 1), np.uint8), poses, sc.period)
    w = drive.Window()
    w.period, w.rings, w.window_frames = PER, [ring] * streams, [(FIRST, FRAMES)] * streams
    w.trajectories, w.metrics = [], []
    for k in range(streams):
        traj = [ring.truth(j).copy() for j in range(FRAMES)]
        met = [{"result": "KEYFRAME" if (j - FIRST) % PER == PER - 1 else "SUCCESS"} for j in range(FRAMES)]
        if fault is not None:
            fault(k, traj, met)
        w.trajectories.append(traj)
        w.metrics.append(met)
    return w


def test_a_sound_window_reads_nothing():
    nums = check.window_numbers(window())
    assert nums["failed_frames"] == nums["keyframe_gap"] == 0 and nums["drift"] < 1e-9


def _one_failed(k, traj, met):
    if k == 1:
        traj[400], met[400]["result"] = None, "FAILED"


def _keyframe_late(k, traj, met):
    if k == 1:
        met[FIRST + 2]["result"], met[FIRST + 3]["result"] = "SUCCESS", "KEYFRAME"


@pytest.mark.parametrize("fault,number", [(_one_failed, "failed_frames"), (_keyframe_late, "keyframe_gap")])
def test_a_fault_in_one_stream_exceeds_its_limit(fault, number):
    nums = check.window_numbers(window(fault=fault))
    assert nums[number] > 0, nums
