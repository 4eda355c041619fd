"""Image overlay suite — copy of ``sdvo_tpu.viz.overlays`` (numpy and
``colorsys``; PIL, imported inside the drawing functions, rasterizes).

The reference draws with OpenCV (named color palette
include/visualization.hpp:33-40, drawing functors :44-55; feature points,
grids, depth colormaps, reprojection overlays, epipolar lines, patch mosaics,
src/visualization.cpp:116-595). Every function takes/returns uint8 numpy RGB
images so outputs drop straight into files. Importing the module imports
neither PIL nor matplotlib.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

# named palette (include/visualization.hpp:33-40)
COLORS = {
    "red": (255, 0, 0),
    "green": (0, 255, 0),
    "blue": (0, 0, 255),
    "cyan": (0, 255, 255),
    "orange": (255, 165, 0),
    "pink": (255, 105, 180),
    "yellow": (255, 255, 0),
    "purple": (160, 32, 240),
    "white": (255, 255, 255),
    "black": (0, 0, 0),
}


def _rgb(color) -> Tuple[int, int, int]:
    return COLORS.get(color, color) if isinstance(color, str) else tuple(color)


def get_color_image(gray: np.ndarray) -> np.ndarray:
    """Grayscale (H, W) → RGB uint8 (``visualization::getColorImage``)."""
    g = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _draw(img: np.ndarray):
    from PIL import Image, ImageDraw

    pil = Image.fromarray(img)
    return pil, ImageDraw.Draw(pil)


def draw_feature_points(
    img: np.ndarray, uv: np.ndarray, radius: int = 4, color="orange", shape: str = "circle"
) -> np.ndarray:
    """circle/rectangle feature markers (``visualization::featurePoints`` with
    drawingCircle/drawingRectangle functors)."""
    pil, d = _draw(img)
    c = _rgb(color)
    for x, y in np.asarray(uv):
        box = [x - radius, y - radius, x + radius, y + radius]
        if shape == "circle":
            d.ellipse(box, outline=c, width=1)
        else:
            d.rectangle(box, outline=c, width=1)
    return np.asarray(pil)


def draw_image_grid(img: np.ndarray, cell_size: int, color="green") -> np.ndarray:
    """Cell grid overlay (``visualization::imageGrid``)."""
    pil, d = _draw(img)
    c = _rgb(color)
    H, W = img.shape[:2]
    for x in range(0, W, cell_size):
        d.line([(x, 0), (x, H - 1)], fill=c, width=1)
    for y in range(0, H, cell_size):
        d.line([(0, y), (W - 1, y)], fill=c, width=1)
    return np.asarray(pil)


def colormap_depth(depths: np.ndarray, d_min: Optional[float] = None, d_max: Optional[float] = None) -> np.ndarray:
    """Depth → RGB jet-style colors (``visualization::colormapDepth``)."""
    d = np.asarray(depths, np.float64)
    d_min = d_min if d_min is not None else np.nanmin(d)
    d_max = d_max if d_max is not None else np.nanmax(d)
    t = np.clip((d - d_min) / max(d_max - d_min, 1e-9), 0, 1)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def draw_reprojected_points(
    img: np.ndarray, uv_proj: np.ndarray, depths: Optional[np.ndarray] = None,
    radius: int = 4,
) -> np.ndarray:
    """Project map points, colored by depth
    (``visualization::projectPointsWithRelativePose`` + colormapDepth)."""
    colors = colormap_depth(depths) if depths is not None else None
    pil, d = _draw(img)
    for i, (x, y) in enumerate(np.asarray(uv_proj)):
        c = tuple(colors[i]) if colors is not None else COLORS["cyan"]
        d.ellipse([x - radius, y - radius, x + radius, y + radius], outline=c, width=1)
    return np.asarray(pil)


def draw_epipolar_lines(
    img: np.ndarray, F: np.ndarray, uv_ref: np.ndarray, color="yellow"
) -> np.ndarray:
    """Epipolar lines l' = F x in the current image
    (``visualization::epipolarLines`` family)."""
    pil, d = _draw(img)
    c = _rgb(color)
    H, W = img.shape[:2]
    for u, v in np.asarray(uv_ref):
        a, b, cc = F @ np.array([u, v, 1.0])
        if abs(b) > 1e-9:
            y0 = -(cc + a * 0) / b
            y1 = -(cc + a * (W - 1)) / b
            d.line([(0, y0), (W - 1, y1)], fill=c, width=1)
    return np.asarray(pil)


def patch_mosaic(patches: np.ndarray, patch_size: int, cols: int = 10, scale: int = 8) -> np.ndarray:
    """Tile N patches into a mosaic (``visualization::referencePatches`` /
    ``residualsPatches``)."""
    N = patches.shape[0]
    rows = (N + cols - 1) // cols
    p = np.asarray(patches).reshape(N, patch_size, patch_size)
    lo, hi = p.min(), p.max()
    p8 = ((p - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    canvas = np.zeros((rows * (patch_size + 1), cols * (patch_size + 1)), np.uint8)
    for i in range(N):
        r, c = divmod(i, cols)
        canvas[
            r * (patch_size + 1) : r * (patch_size + 1) + patch_size,
            c * (patch_size + 1) : c * (patch_size + 1) + patch_size,
        ] = p8[i]
    big = np.kron(canvas, np.ones((scale, scale), np.uint8))
    return np.stack([big] * 3, axis=-1)


def stack_vertically(a: np.ndarray, b: np.ndarray, gap: int = 8) -> np.ndarray:
    """(``visualization::stickTwoImageVertically``)."""
    W = max(a.shape[1], b.shape[1])

    def pad(x):
        if x.shape[1] < W:
            x = np.pad(x, ((0, 0), (0, W - x.shape[1]), (0, 0)))
        return x

    spacer = np.zeros((gap, W, 3), np.uint8)
    return np.concatenate([pad(a), spacer, pad(b)], axis=0)


def get_gray_image(rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 → grayscale (``visualization::getGrayImage``)."""
    a = np.asarray(rgb, np.float64)
    if a.ndim == 2:
        return a.astype(np.uint8)
    return np.clip(0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2], 0, 255).astype(np.uint8)


def generate_color(value: float, vmin: float = 0.0, vmax: float = 1.0) -> Tuple[int, int, int]:
    """Value → hue ramp color (``visualization::generateColor``,
    src/visualization.cpp:95-114): HSV hue sweep blue→red."""
    import colorsys

    t = 0.0 if vmax <= vmin else float(np.clip((value - vmin) / (vmax - vmin), 0, 1))
    r, g, b = colorsys.hsv_to_rgb((1.0 - t) * 2.0 / 3.0, 1.0, 1.0)
    return int(r * 255), int(g * 255), int(b * 255)


def hsv_image_with_magnitude(gradient: np.ndarray) -> np.ndarray:
    """Gradient magnitude as an HSV-coded RGB image
    (``visualization::getHSVImageWithMagnitude``)."""
    import colorsys

    g = np.asarray(gradient, np.float64)
    gmax = max(float(g.max()), 1e-9)
    t = np.clip(g / gmax, 0, 1)
    h = (1.0 - t) * 2.0 / 3.0
    hsv = np.stack([h, np.ones_like(h), t], axis=-1)
    # vectorized hsv→rgb
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    v = t
    p = np.zeros_like(v)
    q = v * (1.0 - f)
    u = v * f
    r = np.choose(i, [v, q, p, p, u, v])
    gg = np.choose(i, [u, v, v, q, p, p])
    b = np.choose(i, [p, p, u, v, v, q])
    return np.clip(np.stack([r, gg, b], axis=-1) * 255, 0, 255).astype(np.uint8)


def draw_candidates(img: np.ndarray, uv: np.ndarray, point_types: np.ndarray,
                    radius: int = 4) -> np.ndarray:
    """Feature markers colored by point type (``visualization::drawCandidate``):
    GOOD=green, CANDIDATE=orange, UNKNOWN=cyan, DELETED=red."""
    from sdvo_tpu_torch.mapping.device_map import PointType

    type_color = {
        int(PointType.GOOD): "green", int(PointType.CANDIDATE): "orange",
        int(PointType.UNKNOWN): "cyan", int(PointType.DELETED): "red",
    }
    pil, d = _draw(img)
    for (x, y), t in zip(np.asarray(uv), np.asarray(point_types)):
        c = _rgb(type_color.get(int(t), "white"))
        d.ellipse([x - radius, y - radius, x + radius, y + radius], outline=c, width=1)
    return np.asarray(pil)


def draw_epipole(img: np.ndarray, epipole_uv: np.ndarray, color="yellow",
                 radius: int = 6) -> np.ndarray:
    """Mark the epipole (``visualization::epipole``): projection of the other
    camera's center."""
    pil, d = _draw(img)
    c = _rgb(color)
    x, y = np.asarray(epipole_uv).reshape(2)
    d.ellipse([x - radius, y - radius, x + radius, y + radius], outline=c, width=2)
    d.line([x - radius - 3, y, x + radius + 3, y], fill=c, width=1)
    d.line([x, y - radius - 3, x, y + radius + 3], fill=c, width=1)
    return np.asarray(pil)


def draw_points_and_projections(img: np.ndarray, uv_obs: np.ndarray,
                                uv_proj: np.ndarray, color_obs="green",
                                color_proj="red") -> np.ndarray:
    """Observed vs projected positions joined by lines
    (``visualization::featurePointsAndProjection`` — the reprojection-error
    overlay)."""
    pil, d = _draw(img)
    co, cp = _rgb(color_obs), _rgb(color_proj)
    for (xo, yo), (xp, yp) in zip(np.asarray(uv_obs), np.asarray(uv_proj)):
        d.line([xo, yo, xp, yp], fill=_rgb("yellow"), width=1)
        d.ellipse([xo - 3, yo - 3, xo + 3, yo + 3], outline=co, width=1)
        d.ellipse([xp - 2, yp - 2, xp + 2, yp + 2], outline=cp, width=1)
    return np.asarray(pil)


def project_depth_filters(img: np.ndarray, uv: np.ndarray, inv_depth_mean: np.ndarray,
                          inv_depth_sigma: np.ndarray, radius: int = 3) -> np.ndarray:
    """Depth filters projected with depth-colored markers whose ring radius
    scales with uncertainty (``visualization::projectDepthFilters``)."""
    mu = np.asarray(inv_depth_mean, np.float64)
    sig = np.asarray(inv_depth_sigma, np.float64)
    lo, hi = (float(mu.min()), float(mu.max())) if mu.size else (0.0, 1.0)
    pil, d = _draw(img)
    smax = max(float(sig.max()), 1e-9) if sig.size else 1.0
    for (x, y), m, sg in zip(np.asarray(uv), mu, sig):
        c = generate_color(m, lo, hi if hi > lo else lo + 1)
        r = radius + int(round(4.0 * sg / smax))
        d.ellipse([x - r, y - r, x + r, y + r], outline=c, width=1)
        d.point([x, y], fill=c)
    return np.asarray(pil)


def draw_epipolar_lines_fundamental(img: np.ndarray, uv_ref: np.ndarray,
                                    F: np.ndarray, color="cyan") -> np.ndarray:
    """Epipolar lines l' = F·[u v 1]ᵀ drawn across the image
    (``visualization::projectLinesWithF``)."""
    H, W = np.asarray(img).shape[:2]
    pil, d = _draw(img)
    c = _rgb(color)
    Fm = np.asarray(F, np.float64)
    for u, v in np.asarray(uv_ref):
        a, b, cc = Fm @ np.asarray([u, v, 1.0])
        if abs(b) < 1e-12:
            continue
        y0 = (-cc - a * 0.0) / b
        y1 = (-cc - a * (W - 1.0)) / b
        d.line([0, y0, W - 1, y1], fill=c, width=1)
    return np.asarray(pil)


def residual_patch_mosaic(ref_patches: np.ndarray, cur_patches: np.ndarray,
                          patch_size: int, cols: int = 10, scale: int = 8) -> np.ndarray:
    """|ref − cur| residual patch mosaic (``visualization::residualsPatches``) —
    normalized per-mosaic for display."""
    r = np.abs(np.asarray(ref_patches, np.float64) - np.asarray(cur_patches, np.float64))
    r = r / max(float(r.max()), 1e-9) * 255.0
    return patch_mosaic(r, patch_size, cols=cols, scale=scale)


def stack_horizontally(a: np.ndarray, b: np.ndarray, gap: int = 8) -> np.ndarray:
    """Side-by-side composition (``visualization::stickTwoImageHorizontally``)."""
    a = np.asarray(a)
    b = np.asarray(b)
    H = max(a.shape[0], b.shape[0])

    def pad(x):
        out = np.zeros((H,) + x.shape[1:], x.dtype)
        out[: x.shape[0]] = x
        return out

    spacer = np.zeros((H, gap) + a.shape[2:], a.dtype)
    return np.concatenate([pad(a), spacer, pad(b)], axis=1)
