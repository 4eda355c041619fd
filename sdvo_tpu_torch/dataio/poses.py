"""Trajectory IO — copy of ``sdvo_tpu.dataio.poses``: the KITTI 3×4
row-major format the reference emits
(``System::writeAllPosesInFile``, src/system.cpp:635-644: 12 numbers per line
of the camera→world transform; failed frames emit "Failed",
src/main.cpp:118-121)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def write_kitti_poses(path: str, poses_wc: List[Optional[np.ndarray]]):
    """poses_wc: list of 4x4 world→camera poses (None → 'Failed' line).

    Writes camera→world 3×4 (the KITTI ground-truth convention)."""
    with open(path, "w") as f:
        for T in poses_wc:
            if T is None:
                f.write("Failed\n")
                continue
            T_cw = np.linalg.inv(T)
            row = T_cw[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def read_kitti_poses(path: str) -> List[Optional[np.ndarray]]:
    """Reads 3×4 camera→world lines; 'Failed' → None. Returns 4x4 matrices."""
    out: List[Optional[np.ndarray]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("Failed"):
                out.append(None)
                continue
            vals = np.asarray([float(x) for x in line.split()])
            T = np.eye(4)
            T[:3, :4] = vals.reshape(3, 4)
            out.append(T)
    return out
