"""Optimizer diagnostics sink — port of ``sdvo_tpu.viz.diagnostics``, the
reference's Optimizer::visualize output.

The reference, when ``Config::visualize`` is on, renders the final residual
histogram (with median/MAD/σ markers), the weight histogram, and the Hessian
heatmap after each LM solve through matplotlib-cpp
(src/optimizer.cpp:516-599, src/visualization.cpp:597-844). Here the
optimizer emits the same quantities, as numpy arrays, to the sink installed
with ``optim.optimizer.set_diagnostics_sink``, and this sink writes the
artifact set to disk via viz.plots.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from sdvo_tpu_torch.viz.plots import draw_histogram, hessian_heatmap


class FileDiagnosticsSink:
    """Writes ``<tag>_<k>_residuals.png / _weights.png / _hessian.png`` per
    solve into ``out_dir`` (one k counter per tag)."""

    def __init__(self, out_dir: str, max_per_tag: int = 200):
        self.out_dir = out_dir
        self.max_per_tag = max_per_tag
        self._counts: Dict[str, int] = {}
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, tag: str, residuals, weights, visible, H) -> None:
        tag = tag or "solve"
        k = self._counts.get(tag, 0)
        if k >= self.max_per_tag:
            return
        self._counts[tag] = k + 1
        vis = np.asarray(visible, bool)
        r = np.asarray(residuals)[vis]
        w = np.asarray(weights)[vis]
        stem = os.path.join(self.out_dir, f"{tag}_{k:04d}")
        draw_histogram(r, stem + "_residuals.png", title=f"{tag} residuals", bins=50)
        draw_histogram(w, stem + "_weights.png", title=f"{tag} weights",
                       bins=50, mark_stats=False)
        hessian_heatmap(np.asarray(H), stem + "_hessian.png", title=f"{tag} JᵀWJ")

    def install(self):
        from sdvo_tpu_torch.optim.optimizer import set_diagnostics_sink

        set_diagnostics_sink(self)
        return self
