"""Dataset IO: image listing/decoding and camera calibration loading — a numpy
copy of ``sdvo_tpu.dataio.datasets``.

Replaces the reference's host-side IO: ``utils::listImageFilesInFolder``
(src/utils.cpp:33-44, sorted directory scan), ``cv::imread`` grayscale
(src/main.cpp:102-130), and the OpenCV-YAML intrinsics loader
``System::loadCameraIntrinsics`` (src/system.cpp:612-633, reads
resource/kitti.yaml / denso.yaml). No OpenCV: PIL decodes, a tiny parser reads
the opencv-matrix YAML schema.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import numpy as np

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".pgm", ".bmp", ".tif", ".tiff")


def list_image_files(folder: str) -> List[str]:
    """Sorted image paths in a directory (utils::listImageFilesInFolder)."""
    files = [
        os.path.join(folder, f)
        for f in sorted(os.listdir(folder))
        if f.lower().endswith(IMAGE_EXTENSIONS)
    ]
    return files


def load_image_grayscale(path: str) -> np.ndarray:
    """uint8 (H, W) grayscale, like cv::imread(..., IMREAD_GRAYSCALE)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)


def load_camera_yaml(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse the reference's OpenCV-YAML intrinsics files (resource/kitti.yaml):
    returns (K 3x3, dist 5). Handles the `!!opencv-matrix` data blocks."""
    with open(path) as f:
        text = f.read()
    mats = {}
    for name, block in re.findall(r"(\w+): !!opencv-matrix\n(.*?)(?=\n\w+:|\Z)", text, re.S):
        data = re.search(r"data:\s*\[(.*?)\]", block, re.S)
        vals = [float(x) for x in data.group(1).replace("\n", " ").split(",")]
        rows = int(re.search(r"rows:\s*(\d+)", block).group(1))
        cols = int(re.search(r"cols:\s*(\d+)", block).group(1))
        mats[name] = np.asarray(vals).reshape(rows, cols)
    K = mats.get("K", np.eye(3))
    d = mats.get("d", np.zeros((5, 1))).reshape(-1)
    if d.shape[0] < 5:
        d = np.concatenate([d, np.zeros(5 - d.shape[0])])
    return K, d[:5]


def load_euroc_sequence(folder: str, cam: str = "cam0"):
    """EuRoC MAV ASL-format sequence reader (BASELINE config 2).

    ``folder`` is the sequence root (e.g. ``MH_01_easy/mav0``) or the camera
    directory itself. Returns (image_paths, timestamps_sec, calib dict) where
    calib holds ``K`` (3×3), ``dist`` (5,) radtan-padded, ``width``/``height``
    — parsed from the ASL ``sensor.yaml`` (camera model: pinhole,
    distortion_model: radial-tangential) without a YAML dependency.

    The reference has no EuRoC loader (it ships KITTI/denso YAMLs only,
    resource/*.yaml); this extends the same ``System::loadCameraIntrinsics``
    surface (src/system.cpp:612-633) to the ASL layout.
    """
    cam_dir = folder
    if os.path.isdir(os.path.join(folder, cam)):
        cam_dir = os.path.join(folder, cam)
    data_dir = os.path.join(cam_dir, "data")
    csv_path = os.path.join(cam_dir, "data.csv")
    yaml_path = os.path.join(cam_dir, "sensor.yaml")

    stamps, paths = [], []
    if os.path.exists(csv_path):
        with open(csv_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, fname = line.split(",")[:2]
                p = os.path.join(data_dir, fname.strip())
                if os.path.exists(p):
                    stamps.append(float(ts) * 1e-9)  # ns → s
                    paths.append(p)
    else:
        paths = list_image_files(data_dir)
        # ASL filenames are the nanosecond timestamps
        for p in paths:
            stem = os.path.splitext(os.path.basename(p))[0]
            stamps.append(float(stem) * 1e-9 if stem.isdigit() else float(len(stamps)))

    calib = {"K": np.eye(3), "dist": np.zeros(5), "width": 752, "height": 480}
    if os.path.exists(yaml_path):
        with open(yaml_path) as f:
            text = f.read()
        intr = re.search(r"intrinsics:\s*\[(.*?)\]", text, re.S)
        if intr:
            fu, fv, cu, cv = [float(x) for x in intr.group(1).split(",")]
            calib["K"] = np.asarray([[fu, 0, cu], [0, fv, cv], [0, 0, 1.0]])
        dist = re.search(r"distortion_coefficients:\s*\[(.*?)\]", text, re.S)
        if dist:
            d = np.asarray([float(x) for x in dist.group(1).split(",")])
            # ASL radtan is [k1, k2, p1, p2]; the pipeline's 5-vector is
            # [k1, k2, p1, p2, k3]
            calib["dist"] = np.concatenate([d, np.zeros(max(0, 5 - d.shape[0]))])[:5]
        res = re.search(r"resolution:\s*\[(.*?)\]", text, re.S)
        if res:
            w, h = [int(float(x)) for x in res.group(1).split(",")]
            calib["width"], calib["height"] = w, h
    return paths, np.asarray(stamps), calib


def load_kitti_calib(calib_path: str, cam: int = 0) -> np.ndarray:
    """KITTI odometry calib.txt → 3x4 projection matrix P{cam}."""
    with open(calib_path) as f:
        for line in f:
            if line.startswith(f"P{cam}:"):
                vals = [float(x) for x in line.split()[1:]]
                return np.asarray(vals).reshape(3, 4)
    raise ValueError(f"P{cam} not found in {calib_path}")
