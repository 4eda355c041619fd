"""Overlays, optimizer plots and the diagnostics sink — port of ``sdvo_tpu.viz``."""

from sdvo_tpu_torch.viz.overlays import (  # noqa: F401
    COLORS,
    colormap_depth,
    draw_epipolar_lines,
    draw_feature_points,
    draw_image_grid,
    draw_reprojected_points,
    get_color_image,
    patch_mosaic,
    stack_vertically,
)
from sdvo_tpu_torch.viz.plots import draw_histogram, hessian_heatmap  # noqa: F401
