"""The port's ``viz`` (overlays, plots, the diagnostics sink), ``utils.io``
and ``dataio.poses`` on the CPU against the JAX package, and visualization
through the port's ``System`` and ``SparseImageAlign``.

Overlays are held bit for bit; files written by one package are read back
by the other. The alignment diagnostics are compared with the JAX aligner's
XLA path (one ``optimize_lm`` a level) on ``test_torch_system``'s two-host
scene: level 0's visibility mask equal, its JᵀWJ within 0.5 % of the
largest entry (measured 0.13 %; both in float32, and the port evaluates at
the pose K1 returned, which puts every feature within 0.01 px of the JAX
pose: residuals move by up to 0.04 grey levels and the Tukey weights, whose
scale is a histogram MAD, by up to 0.08).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sdvo_tpu.dataio.poses as jposes
import sdvo_tpu.utils.io as jio
import sdvo_tpu.viz.overlays as jov
from sdvo_tpu.align.image_alignment import AlignFeatures as JAlignFeatures
from sdvo_tpu.align.image_alignment import SparseImageAlign as JSparseImageAlign
from sdvo_tpu.geometry.se3 import SE3 as JSE3
from sdvo_tpu.optim import optimizer as jopt

import sdvo_tpu_torch.dataio.poses as tposes
import sdvo_tpu_torch.utils.io as tio
import sdvo_tpu_torch.viz.overlays as tov
from sdvo_tpu_torch.align.image_alignment import AlignFeatures, SparseImageAlign
from sdvo_tpu_torch.config import load_config
from sdvo_tpu_torch.geometry.camera import PinholeCamera
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.pyramid import build_pyramid
from sdvo_tpu_torch.optim import optimizer as topt
from sdvo_tpu_torch.pipeline.system import System
from sdvo_tpu_torch.viz.diagnostics import FileDiagnosticsSink
from sdvo_tpu_torch.viz.plots import draw_histogram, hessian_heatmap

from test_pipeline_e2e import CAM, make_sequence
from test_torch_modules import _np, _t
from test_torch_system import _two_host_problem


def _overlay_cases():
    g = np.random.default_rng(11)
    img = tov.get_color_image(g.uniform(0, 255, (60, 80)))
    uv = g.uniform(5, 55, (8, 2))
    F = g.normal(size=(3, 3))
    patches = g.normal(size=(7, 25))
    return {
        "get_color_image": ("get_color_image", (g.uniform(-20, 280, (30, 40)),), {}),
        "draw_feature_points": ("draw_feature_points", (img, uv), dict(color="pink")),
        "draw_feature_points_rect": ("draw_feature_points", (img, uv), dict(shape="rect", radius=3)),
        "draw_image_grid": ("draw_image_grid", (img, 20), {}),
        "colormap_depth": ("colormap_depth", (g.uniform(1, 10, 9),), {}),
        "draw_reprojected_points": ("draw_reprojected_points", (img, uv, g.uniform(1, 9, 8)), {}),
        "draw_reprojected_points_plain": ("draw_reprojected_points", (img, uv), {}),
        "draw_epipolar_lines": ("draw_epipolar_lines", (img, F, uv[:3]), {}),
        "patch_mosaic": ("patch_mosaic", (patches, 5), {}),
        "stack_vertically": ("stack_vertically", (img, img[:, :50]), {}),
        "get_gray_image": ("get_gray_image", (img,), {}),
        "generate_color": ("generate_color", (0.3, 0.0, 1.0), {}),
        "hsv_image_with_magnitude": ("hsv_image_with_magnitude", (g.uniform(0, 50, (30, 40)),), {}),
        "draw_candidates": ("draw_candidates", (img, uv, np.asarray([0, 1, 2, 3, 0, 1, 2, 3])), {}),
        "draw_epipole": ("draw_epipole", (img, np.asarray([40.0, 30.0])), {}),
        "draw_points_and_projections": ("draw_points_and_projections",
                                        (img, uv, uv + g.normal(0, 2, uv.shape)), {}),
        "project_depth_filters": ("project_depth_filters",
                                  (img, uv, g.uniform(0.05, 0.2, 8), g.uniform(0.001, 0.05, 8)), {}),
        "draw_epipolar_lines_fundamental": ("draw_epipolar_lines_fundamental", (img, uv[:3], F), {}),
        "residual_patch_mosaic": ("residual_patch_mosaic",
                                  (g.uniform(0, 255, (6, 25)), g.uniform(0, 255, (6, 25)), 5), {}),
        "stack_horizontally": ("stack_horizontally", (img, img[:40]), {}),
    }


OVERLAYS = _overlay_cases()


@pytest.mark.parametrize("case", sorted(OVERLAYS))
def test_overlay_matches_jax(case):
    """Every overlay function's output, bit for bit."""
    name, args, kw = OVERLAYS[case]
    got, want = np.asarray(getattr(tov, name)(*args, **kw)), np.asarray(getattr(jov, name)(*args, **kw))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_plots_and_file_sink(tmp_path):
    """The plots write their PNGs; ``FileDiagnosticsSink`` writes a
    residual, a weight and a Hessian PNG a solve, counted per tag, up to
    ``max_per_tag``, and installs itself as the optimizer's sink."""
    draw_histogram(np.random.default_rng(0).normal(size=500), str(tmp_path / "h.png"))
    hessian_heatmap(np.eye(6), str(tmp_path / "H.png"))
    assert (tmp_path / "h.png").exists() and (tmp_path / "H.png").exists()
    sink = FileDiagnosticsSink(str(tmp_path / "diag"), max_per_tag=2)
    r = np.random.default_rng(1).normal(size=40)
    for _ in range(3):
        sink("align", r, np.abs(r), r > -1.0, np.eye(6))
    sink("", r, np.abs(r), np.ones(40, bool), np.eye(6))
    names = sorted(os.listdir(tmp_path / "diag"))
    assert names == sorted(f"{t}_{k:04d}_{kind}.png" for t, ks in (("align", (0, 1)), ("solve", (0,)))
                           for k in ks for kind in ("residuals", "weights", "hessian"))
    try:
        assert sink.install() is sink and topt._DIAGNOSTICS_SINK is sink
    finally:
        topt.set_diagnostics_sink(None)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_io_files_cross_read(tmp_path, writer):
    """``utils.io``'s three text formats and the KITTI poses: a file written
    by one package is read back by the other, with the same values."""
    w, r = (tio, jio) if writer == "port" else (jio, tio)
    pw, pr = (tposes, jposes) if writer == "port" else (jposes, tposes)
    g = np.random.default_rng(3)
    pose = np.eye(4)
    pose[:3, 3] = [1, 2, 3]
    uv, pts = g.uniform(0, 100, (5, 2)), g.uniform(-5, 5, (5, 3))
    w.write_debug_dump(str(tmp_path / "dump.txt"), pose, uv, pts)
    for a, b in zip(r.read_debug_dump(str(tmp_path / "dump.txt")), (pose, uv, pts)):
        np.testing.assert_allclose(a, b, rtol=1e-11)
    cur = g.uniform(0, 100, (5, 2))
    w.write_all_info_file(str(tmp_path / "all.txt"), uv, cur, pts)
    for a, b in zip(r.read_all_from_file(str(tmp_path / "all.txt")), (uv, cur, pts)):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    w.write_features_info_file(str(tmp_path / "feats.txt"), uv, cur)
    for a, b in zip(r.read_features_from_file(str(tmp_path / "feats.txt")), (uv, cur)):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    q = np.linalg.qr(g.normal(size=(3, 3)))[0]
    T = np.eye(4)
    T[:3, :3] = q * np.sign(np.linalg.det(q))
    T[:3, 3] = g.normal(size=3)
    traj = [np.eye(4), None, T]
    pw.write_kitti_poses(str(tmp_path / "poses.txt"), traj)
    back = pr.read_kitti_poses(str(tmp_path / "poses.txt"))
    assert back[1] is None
    for a, b in ((back[0], traj[0]), (back[2], np.linalg.inv(T))):
        np.testing.assert_allclose(a, b, atol=1e-8)
    assert tio.find_absolute_path("config/config.json") == jio.find_absolute_path("config/config.json")
    assert tio.repo_root() == jio.repo_root()


def test_alignment_diagnostics_match_jax():
    """``SparseImageAlign.align`` with ``visualize`` on: one sink call a
    level, with the alignment tag; level 0's (the last call's) visibility
    equal to the JAX XLA path's, its JᵀWJ symmetric and within 0.5 % of the
    JAX one's largest entry, residuals and weights finite."""
    ref, kf, cur, uv_host, host, pts, valid, _ = _two_host_problem()
    fx, fy, cx, cy = (CAM[k] for k in ("fx", "fy", "cx", "cy"))
    levels = 2
    pr, pk, pc = (build_pyramid(_t(x), levels) for x in (ref, kf, cur))
    settings = SparseImageAlign.DEFAULT_SETTINGS._replace(visualize=True, viz_tag="image_alignment")
    ja = JSparseImageAlign(patch_size=5, min_level=0, max_level=levels - 1, backend="xla",
                           settings=jopt.LMSettings(**settings._asdict()))
    ta = SparseImageAlign(patch_size=5, min_level=0, max_level=levels - 1, settings=settings)
    jgot, tgot = [], []
    jopt.set_diagnostics_sink(lambda *a: jgot.append(a))
    topt.set_diagnostics_sink(lambda *a: tgot.append(a))
    try:
        jhost = tuple(jnp.stack([jnp.asarray(_np(pr.images[lv])), jnp.asarray(_np(pk.images[lv]))])
                      for lv in range(levels))
        f32 = jnp.float32
        ja.align(JSE3(jnp.eye(3, dtype=f32), jnp.zeros(3, f32)), jhost, tuple(jnp.asarray(_np(im)) for im in pc.images),
                 JAlignFeatures(*map(jnp.asarray, (uv_host, host, pts, valid))), f32(fx), f32(fy), f32(cx), f32(cy))
        jax.effects_barrier()
        ta.align(SE3.identity(), [(pr.images[lv], pk.images[lv]) for lv in range(levels)], pc.images,
                 AlignFeatures(_t(uv_host), _t(host), _t(pts), _t(valid)), fx, fy, cx, cy)
    finally:
        jopt.set_diagnostics_sink(None)
        topt.set_diagnostics_sink(None)
    assert len(tgot) == len(jgot) == levels
    assert all(c[0] == "image_alignment" for c in tgot + jgot)
    (_, r, w, vis, H), (_, jr, jw, jvis, jH) = tgot[-1], jgot[-1]
    assert r.shape == jr.shape and H.shape == jH.shape == (6, 6)
    np.testing.assert_array_equal(vis, jvis)
    assert np.isfinite(r).all() and np.isfinite(w).all() and vis.sum() > 100
    np.testing.assert_allclose(H, H.T, rtol=1e-6, atol=1e-6 * np.abs(H).max())
    np.testing.assert_allclose(H, jH, rtol=0, atol=5e-3 * np.abs(jH).max())


def _viz_config(tmp_path, enable):
    over = {
        "camera": {"img_width": CAM["width"], "img_height": CAM["height"]},
        "initialization": {
            "min_detected_points": 60, "desired_detected_points": 150,
            "threshold_gradient_magnitude": 20, "disparity_threshold": 2,
        },
        "algorithm": {"min_tracked_features": 20, "max_dropped_features": 150},
        "file_paths": {"output_dir": str(tmp_path)},
    }
    if enable:
        over["visualization"] = {"enable_visualization": True, "saving_type": "File"}
    return load_config(overrides=over)


def test_system_visualization_writes_stage_pngs(tmp_path):
    """The port's ``System`` with File visualization over the frames of the
    JAX package's ``test_visualization_gated_dumps`` writes the same set of
    stage PNGs (``detect``, ``reproject``) and, under ``diagnostics``, the
    three plots of every ``image_alignment`` level and ``pose_refine``
    solve; with the default configuration it writes nothing."""
    _, images, _ = make_sequence(np.random.default_rng(42), n_frames=5)
    try:
        sys_ = System(_viz_config(tmp_path, True), camera=PinholeCamera.create(**CAM), device="cpu")
        for i, img in enumerate(images):
            sys_.add_image(np.asarray(img, np.float64), float(i))
    finally:
        topt.set_diagnostics_sink(None)
    assert "FAILED" not in [m["result"] for m in sys_.metrics], sys_.metrics
    pngs = glob.glob(os.path.join(str(tmp_path), "images", "*.png"))
    assert {os.path.basename(p).split("_", 1)[1] for p in pngs} == {"detect.png", "reproject.png"}, pngs
    diags = [os.path.basename(p) for p in glob.glob(os.path.join(str(tmp_path), "diagnostics", "*.png"))]
    tracked = len(images) - 2  # frames after the two-view bootstrap
    levels = sys_.num_levels - sys_.aligner.min_level
    for tag, n in (("image_alignment", levels * tracked), ("pose_refine", tracked)):
        for kind in ("residuals", "weights", "hessian"):
            assert sum(d.startswith(tag) and d.endswith(f"_{kind}.png") for d in diags) == n, (tag, kind, diags)

    off = tmp_path / "off"
    sys_off = System(_viz_config(off, False), camera=PinholeCamera.create(**CAM), device="cpu")
    for i, img in enumerate(images[:3]):
        sys_off.add_image(np.asarray(img, np.float64), float(i))
    assert not off.exists() and topt._DIAGNOSTICS_SINK is None
