"""``topk_stable`` — from ``sdvo_tpu_torch.geometry.essential``."""

from __future__ import annotations

import torch


def topk_stable(x: torch.Tensor, k: int, dim: int = -1):
    """``jax.lax.top_k`` semantics: the k largest along ``dim``, ties resolved
    to the lower index (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)
