"""Configuration tree for the PyTorch port of the SVO pipeline (a verbatim copy
of ``sdvo_tpu.config``, so the port never imports the JAX package).

Mirrors the reference's JSON schema (its ``config/config.json``,
parsed + validated in ``src/config.cpp:31-93`` / ``include/config.hpp:41-61``)
as frozen dataclasses, extended with the fixed-capacity knobs a static-shape
JAX design needs (max features / points / filters / keyframes) and the
parallelism knobs of the TPU build (mesh axes, dtype policy).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class FilePathsConfig:
    """Section ``file_paths`` (src/config.cpp:33-41)."""

    camera_calibration_file: str = "resource/kitti.yaml"
    log_file: str = ""
    image_data_path: str = ""
    output_dir: str = "output"


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Section ``camera`` (src/config.cpp:43-48)."""

    img_width: int = 1241
    img_height: int = 376


@dataclasses.dataclass(frozen=True)
class VisualizationConfig:
    """Section ``visualization`` (src/config.cpp:50-55)."""

    enable_visualization: bool = False
    saving_type: str = "File"  # "File" | "LiveShow"


@dataclasses.dataclass(frozen=True)
class InitializationConfig:
    """Section ``initialization`` (src/config.cpp:57-72)."""

    patch_size_optical_flow: int = 11
    threshold_gradient_magnitude: int = 50
    min_detected_points: int = 100
    desired_detected_points: int = 200
    map_scale_factor: float = 1.0
    disparity_threshold: int = 5
    # TPU-native additions: RANSAC over vmapped 8-point hypotheses replaces
    # cv::findEssentialMat (src/algorithm.cpp:130).
    ransac_hypotheses: int = 256
    ransac_threshold_px: float = 1.0
    klt_pyramid_levels: int = 4
    klt_iterations: int = 20


@dataclasses.dataclass(frozen=True)
class AlgorithmConfig:
    """Section ``algorithm`` (src/config.cpp:74-93) + static-shape capacities."""

    cell_pixel_size: int = 30
    patch_size_image_alignment: int = 5
    min_level_image_pyramid: int = 0
    max_level_image_pyramid: int = 3
    # Feature-alignment patch (reference hard-codes 5 in FeatureAlignment ctor,
    # src/system.cpp:24) and its error threshold (src/map.cpp:538,608).
    patch_size_feature_alignment: int = 5
    feature_alignment_max_error: float = 50.0
    # Keyframe policy: every Nth frame (src/system.cpp:505-510 uses diffId < 3).
    keyframe_every_n: int = 3
    max_keyframes: int = 7  # sliding window eviction (src/system.cpp:436-442)
    # Tracking-quality gate (src/system.cpp:459-472).
    min_tracked_features: int = 50
    max_dropped_features: int = 40
    # Reprojection cap per frame (src/map.cpp:484-487).
    max_reprojection_matches: int = 150
    # Depth-filter knobs (src/depth_estimator.cpp).
    filter_staleness_keyframes: int = 5
    filter_convergence_sigma_factor: float = 10.0
    # --- static capacities (TPU-native: fixed shapes + masks) ---
    max_features_per_frame: int = 256
    max_points: int = 4096
    max_filters: int = 512
    # Epipolar search: fixed number of samples along the segment
    # (replaces the variable-length walk at src/algorithm.cpp:509-547).
    epipolar_search_steps: int = 16
    # LM settings (src/optimizer.cpp:13-27).
    max_lm_iterations: int = 20
    # Structure-only GN passes before the joint local-BA solve — the
    # reference's localBA structure stage (src/bundle_adjustment.cpp:480-625).
    # 0 = off (the joint solve usually converges in 2-3 steps anyway).
    ba_structure_presolve: int = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """TPU-build parallelism axes (no analog in the reference — SURVEY §2.4)."""

    sequence_axis: str = "seq"  # data-parallel over independent videos
    shard_axis: str = "shard"  # landmark-block sharding for distributed BA
    num_sequences: int = 1
    num_shards: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    file_paths: FilePathsConfig = dataclasses.field(default_factory=FilePathsConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    visualization: VisualizationConfig = dataclasses.field(default_factory=VisualizationConfig)
    initialization: InitializationConfig = dataclasses.field(default_factory=InitializationConfig)
    algorithm: AlgorithmConfig = dataclasses.field(default_factory=AlgorithmConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    # dtype policy: compute dtype for device kernels; pose accumulation on host
    # is always float64 (reference is all-double Eigen; see SURVEY §7 hard part f).
    compute_dtype: str = "float32"

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _filter_fields(cls: type, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def load_config(path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a config from the reference-compatible JSON schema.

    Unknown keys are ignored; missing keys take defaults (the reference instead
    hard-FATALs on missing keys, src/config.cpp:12-29 — we prefer defaults so
    partial configs compose).
    """
    raw: Dict[str, Any] = {}
    if path is not None and os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
    if overrides:
        for k, v in overrides.items():
            raw.setdefault(k, {}).update(v if isinstance(v, dict) else {k: v})

    sections = {
        "file_paths": FilePathsConfig,
        "camera": CameraConfig,
        "visualization": VisualizationConfig,
        "initialization": InitializationConfig,
        "algorithm": AlgorithmConfig,
        "parallel": ParallelConfig,
    }
    kwargs: Dict[str, Any] = {}
    for key, cls in sections.items():
        kwargs[key] = cls(**_filter_fields(cls, raw.get(key, {})))
    if "compute_dtype" in raw:
        kwargs["compute_dtype"] = raw["compute_dtype"]
    return Config(**kwargs)
