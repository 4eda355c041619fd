"""Optimizer diagnostics plots — copy of ``sdvo_tpu.viz.plots``, the
matplotlib-cpp replacement. matplotlib is imported inside each function, so
importing the module needs none.

The reference embeds Python via matplotlib-cpp to draw residual/weight
histograms with median/MAD/sigma markers and Hessian heatmaps
(src/visualization.cpp:597-844, driven by ``Optimizer::visualize``,
src/optimizer.cpp:516-599). We ARE Python: matplotlib directly, Agg backend,
file output only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def draw_histogram(
    values: np.ndarray,
    path: str,
    title: str = "residuals",
    bins: int = 100,
    mark_stats: bool = True,
):
    """Histogram with median / median±1.4826·MAD markers."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    v = np.asarray(values).ravel()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(v, bins=bins, color="#4878cf", alpha=0.85)
    if mark_stats and v.size:
        med = float(np.median(v))
        mad = float(np.median(np.abs(v - med)))
        sigma = 1.4826 * mad
        ax.axvline(med, color="k", lw=2, label=f"median {med:.3g}")
        ax.axvline(med - sigma, color="r", ls="--", lw=1, label=f"±σ ({sigma:.3g})")
        ax.axvline(med + sigma, color="r", ls="--", lw=1)
        ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def hessian_heatmap(H: np.ndarray, path: str, title: str = "hessian"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(np.asarray(H), cmap="viridis")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
