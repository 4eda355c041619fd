"""Path helpers + debug feature/point text serialization — copy of
``sdvo_tpu.utils.io`` (numpy only).

Replaces ``utils.cpp``: repo-root-relative path resolution (:15-31 strips
build/bin from cwd — here: walk up to the directory containing this package),
and the feature/point text dump/restore used for optimizer debugging
(``writeAllInfoFile`` / ``readAllFromFile``, src/utils.cpp:54-117).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np


def repo_root() -> str:
    """Directory containing the sdvo_tpu_torch package (findAbsoluteFilePath
    base): the repository root."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def find_absolute_path(relative: str) -> str:
    """Resolve a path relative to the repo root (utils::findAbsoluteFilePath)."""
    if os.path.isabs(relative):
        return relative
    return os.path.join(repo_root(), relative)


def write_debug_dump(path: str, pose_wc: np.ndarray, feat_uv: np.ndarray, points_w: np.ndarray):
    """Text dump of one frame's pose + per-feature (uv, 3D point) rows
    (utils::writeAllInfoFile)."""
    with open(path, "w") as f:
        f.write("pose " + " ".join(f"{v:.12g}" for v in pose_wc.reshape(-1)) + "\n")
        for uv, p in zip(feat_uv, points_w):
            f.write(
                "feat "
                + " ".join(f"{v:.12g}" for v in uv)
                + " "
                + " ".join(f"{v:.12g}" for v in p)
                + "\n"
            )


def read_debug_dump(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of write_debug_dump (utils::readAllFromFile)."""
    pose = np.eye(4)
    uvs: List[List[float]] = []
    pts: List[List[float]] = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "pose":
                pose = np.asarray([float(x) for x in tok[1:]]).reshape(4, 4)
            elif tok[0] == "feat":
                vals = [float(x) for x in tok[1:]]
                uvs.append(vals[:2])
                pts.append(vals[2:5])
    return pose, np.asarray(uvs), np.asarray(pts)


def write_all_info_file(path: str, ref_uv: np.ndarray, cur_uv: np.ndarray,
                        points_w: np.ndarray):
    """Reference-format debug rows: ``refx refy curx cury px py pz`` per
    feature pair — byte-compatible with ``utils::writeAllInfoFile``
    (src/utils.cpp:54-64), so dumps interchange with the
    reference's readAllFromFile."""
    with open(path, "w") as f:
        for r, c, p in zip(np.asarray(ref_uv), np.asarray(cur_uv), np.asarray(points_w)):
            f.write(f"{r[0]:.6g} {r[1]:.6g} {c[0]:.6g} {c[1]:.6g} "
                    f"{p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n")


def read_all_from_file(path: str):
    """Inverse of write_all_info_file (utils::readAllFromFile,
    src/utils.cpp:77-100). Returns (ref_uv, cur_uv, points)."""
    vals = np.loadtxt(path, ndmin=2)
    if vals.size == 0:
        z = np.zeros((0, 2))
        return z, z.copy(), np.zeros((0, 3))
    return vals[:, 0:2], vals[:, 2:4], vals[:, 4:7]


def write_features_info_file(path: str, ref_uv: np.ndarray, cur_uv: np.ndarray):
    """``refx refy curx cury`` rows (utils::writeFeaturesInfoFile,
    src/utils.cpp:66-75)."""
    with open(path, "w") as f:
        for r, c in zip(np.asarray(ref_uv), np.asarray(cur_uv)):
            f.write(f"{r[0]:.6g} {r[1]:.6g} {c[0]:.6g} {c[1]:.6g}\n")


def read_features_from_file(path: str):
    """Inverse of write_features_info_file (utils::readFeaturesFromFile)."""
    vals = np.loadtxt(path, ndmin=2)
    if vals.size == 0:
        z = np.zeros((0, 2))
        return z, z.copy()
    return vals[:, 0:2], vals[:, 2:4]
