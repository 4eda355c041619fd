"""Per-feature windows and separable bilinear patch sampling — port of
``sdvo_tpu.ops.window_sampler`` (``window_gather``, ``sample_windows``,
``sample_windows_grad``).

``window_gather`` is a direct row gather from the zero-padded image. The JAX
reference builds an overlapping two-block row layout first, which is how a
TPU gathers fast; the clip and ``ok`` rules here are the reference's exactly:
the window's columns start at a ``block``-aligned origin clipped to
``[0, nb-2]`` blocks, its rows at ``floor(v) - win_h//2`` clipped to
``[0, H-win_h]``, and ``ok`` tests the sub-pixel centre against the borders.

The samplers evaluate ``patch[n,p,q] = Σ_h Σ_w tri(y0+p−h)·tri(x0+q−w)·win[n,h,w]``
with ``tri(d) = max(0, 1−|d|)`` — bilinear interpolation as two contractions,
the same weights the kernels of ``sdvo_tpu_torch.ops`` evaluate tap by tap.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def window_gather(image: torch.Tensor, uv: torch.Tensor, win_h: int = 16,
                  block: int = 16) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (windows (N, win_h, 2·block), origin (N, 2) as (x, y) in uv's
    dtype, ok (N,) — the patch support around uv lies inside the image)."""
    H, W = image.shape
    nb = -(-W // block)
    Wp = nb * block
    img_p = F.pad(image, (0, Wp - W)) if Wp != W else image
    half = win_h // 2
    fx = torch.floor(uv[..., 0]).to(torch.int64)
    fy = torch.floor(uv[..., 1]).to(torch.int64)
    oy = torch.clamp(fy - half, min=0)
    oy = torch.minimum(oy, torch.full_like(oy, H - win_h))
    bx = torch.clamp(torch.div(fx - block // 2, block, rounding_mode="floor"), 0, nb - 2)
    rows = torch.clamp(oy[:, None] + torch.arange(win_h, device=uv.device), 0, H - 1)
    cols = torch.clamp(bx[:, None] * block + torch.arange(2 * block, device=uv.device), 0, Wp - 1)
    windows = img_p[rows[:, :, None], cols[:, None, :]]
    origin = torch.stack([(bx * block).to(uv.dtype), oy.to(uv.dtype)], dim=-1)
    ok = (
        (uv[..., 0] >= block // 2) & (uv[..., 0] < W - block // 2)
        & (uv[..., 1] >= half) & (uv[..., 1] < H - half)
    )
    return windows, origin, ok


def _tri_weights(center: torch.Tensor, patch: int, win: int) -> torch.Tensor:
    """(N, patch, win) weights w[n,p,h] = tri(center[n]+p−h)."""
    p = torch.arange(patch, dtype=center.dtype, device=center.device)[None, :, None]
    h = torch.arange(win, dtype=center.dtype, device=center.device)[None, None, :]
    return torch.clamp(1.0 - torch.abs(center[:, None, None] + p - h), min=0.0)


def sample_windows(windows: torch.Tensor, offs: torch.Tensor, patch: int):
    """Bilinear P×P patches centred at ``offs`` (window coords). Returns
    (vals (N, P²), ok (N,)) — ok: the patch plus 1 px of support inside."""
    N, WH, WW = windows.shape
    half = patch // 2
    y0 = offs[..., 1].to(windows.dtype) - half
    x0 = offs[..., 0].to(windows.dtype) - half
    tmp = torch.einsum("nph,nhw->npw", _tri_weights(y0, patch, WH), windows)
    out = torch.einsum("npw,nqw->npq", tmp, _tri_weights(x0, patch, WW))
    ok = (x0 >= 1) & (y0 >= 1) & (x0 + patch <= WW - 1) & (y0 + patch <= WH - 1)
    return out.reshape(N, patch * patch), ok


def sample_windows_grad(windows: torch.Tensor, offs: torch.Tensor, patch: int):
    """Patches + central-difference gradients. Returns (patch, gx, gy, ok),
    ok with 2 px of support (the ±1 gradient taps)."""
    N, WH, WW = windows.shape
    half = patch // 2
    y0 = offs[..., 1].to(windows.dtype) - half
    x0 = offs[..., 0].to(windows.dtype) - half
    Vy = _tri_weights(y0, patch, WH)
    Vx = _tri_weights(x0, patch, WW)
    dVy = _tri_weights(y0 + 1.0, patch, WH) - _tri_weights(y0 - 1.0, patch, WH)
    dVx = _tri_weights(x0 + 1.0, patch, WW) - _tri_weights(x0 - 1.0, patch, WW)
    tmp = torch.einsum("nph,nhw->npw", Vy, windows)
    val = torch.einsum("npw,nqw->npq", tmp, Vx)
    gx = 0.5 * torch.einsum("npw,nqw->npq", tmp, dVx)
    gy = 0.5 * torch.einsum("npw,nqw->npq", torch.einsum("nph,nhw->npw", dVy, windows), Vx)
    ok = (x0 >= 2) & (y0 >= 2) & (x0 + patch <= WW - 2) & (y0 + patch <= WH - 2)
    P2 = patch * patch
    return val.reshape(N, P2), gx.reshape(N, P2), gy.reshape(N, P2), ok
