"""Kernel problems at main-path shapes and the kernel-vs-plain check.

Builds, from a seed, inputs for K1–K4 shaped as the main path hands them to
the kernels (a rendered textured plane, features on a grid, windows and
tables made by the port's own samplers), runs each hand-written kernel and
its plain PyTorch version on the same tensors, and reports the largest
disagreement and both times. ``chip_smoke.py`` runs it on the card at the
main path's sizes; the CPU tests build the same problems at small sizes.
"""

from __future__ import annotations

import statistics
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from scipy.linalg import expm

from sdvo_tpu_torch.dataio.synthetic import render_plane, smooth_texture
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.interp import padded_patch_and_gradients
from sdvo_tpu_torch.image.pyramid import abs_gradient_saturated_sum, build_pyramid
from sdvo_tpu_torch.ops import depth_scores, fa_align, lm_align, pose_refine
from sdvo_tpu_torch.ops.window_sampler import sample_windows_grad, window_gather


class _Pose:
    def __init__(self, T):
        self.rotation = T[:3, :3]
        self.translation = T[:3, 3]


def se3_np(tau) -> np.ndarray:
    tau = np.asarray(tau, np.float64)
    xi = np.zeros((4, 4))
    w = tau[3:]
    xi[:3, :3] = [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
    xi[:3, 3] = tau[:3]
    return expm(xi)


def plane_pair(seed: int, tau, width: int, height: int, tex_size: int = 1024):
    """Reference and current float32 images of a textured plane at z = 10
    under the motion ``tau``, and the camera (f = width, centred)."""
    rng = np.random.default_rng(seed)
    tex = smooth_texture(rng, size=tex_size, blur=15)
    cam = SimpleNamespace(fx=float(width), fy=float(width), cx=width / 2.0, cy=height / 2.0,
                          width=width, height=height)
    ref = render_plane(tex, cam, _Pose(np.eye(4)), 10.0)
    cur = render_plane(tex, cam, _Pose(se3_np(tau)), 10.0)
    return ref.astype(np.float32), cur.astype(np.float32), cam


def lm_problems(device, n: int = 256, width: int = 1241, height: int = 376, levels: int = 4,
                seed: int = 0):
    """K1 inputs for every pyramid level: a list of (args, max_iters), args
    in ``lm_align_level`` order after ``T_init``."""
    ref, cur, cam = plane_pair(seed, [0.02, -0.01, 0.015, 0.002, -0.003, 0.004], width, height,
                               tex_size=2048)
    pr = build_pyramid(torch.from_numpy(ref), levels)
    pc = build_pyramid(torch.from_numpy(cur), levels)
    side = int(np.ceil(np.sqrt(n * width / height)))
    us = np.linspace(40, width - 40, side)
    vs = np.linspace(40, height - 40, int(np.ceil(n / side)))
    uu, vv = np.meshgrid(us, vs)
    uv = np.stack([uu.ravel(), vv.ravel()], -1)[:n].astype(np.float32)
    b = np.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy, np.ones(n)], -1)
    pts = (b * 10.0).astype(np.float32)
    x, y, z = (torch.from_numpy(pts[:, i]) for i in range(3))
    out = []
    for lv in range(levels):
        s = 1.0 / (1 << lv)
        fx, fy, cx, cy = cam.fx * s, cam.fy * s, cam.cx * s, cam.cy * s
        uv_l = torch.from_numpy(uv) * s
        win_r, org_r, ok_r = window_gather(pr.images[lv], uv_l, 16)
        patches, gx, gy, ok_s = sample_windows_grad(win_r, uv_l - org_r, 5)
        iz = 1.0 / z
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        row_u = torch.stack([fx * iz, zero, -fx * x * iz2, -fx * x * y * iz2, fx * (1 + x * x * iz2), -fx * y * iz], -1)
        row_v = torch.stack([zero, fy * iz, -fy * y * iz2, -fy * (1 + y * y * iz2), fy * x * y * iz2, fy * x * iz], -1)
        J = gx[..., None] * row_u[:, None] + gy[..., None] * row_v[:, None]
        uv0 = torch.stack([fx * x / z + cx, fy * y / z + cy], -1)
        win_c, org_c, ok_c = window_gather(pc.images[lv], uv0, 16)
        vis = ok_r & ok_s & ok_c
        J = torch.where(vis[:, None, None], J, torch.zeros_like(J))
        args = [t.contiguous().to(device) for t in (win_c, patches, J, torch.from_numpy(pts), org_c, vis)]
        out.append((args + [fx, fy, cx, cy], max(4, 10 - 2 * (levels - 1 - lv))))
    return out


def fa_problem(device, n: int = 150, width: int = 1241, height: int = 376, seed: int = 1):
    """K2 inputs: gradient windows (n, 24, 32) around perturbed positions,
    cached reference patch tables, origins and the live mask."""
    ref, cur, _ = plane_pair(seed, [0.012, -0.008, 0.0, 0.0, 0.0, 0.0], width, height)
    gref = abs_gradient_saturated_sum(torch.from_numpy(ref))
    gcur = abs_gradient_saturated_sum(torch.from_numpy(cur))
    rng = np.random.default_rng(seed)
    uv_ref = rng.uniform(40, [width - 40, height - 40], size=(n, 2)).astype(np.float32)
    patch, gx, gy, ok = padded_patch_and_gradients(gref, torch.from_numpy(uv_ref), 5)
    uv_init = torch.from_numpy((uv_ref + rng.normal(0, 0.5, size=(n, 2))).astype(np.float32))
    win, org, ok_w = window_gather(gcur, uv_init, 24)
    live = ok & ok_w
    live[-2:] = False
    return [t.contiguous().to(device) for t in (win, patch, gx, gy, uv_init, org, live)]


def pose_problem(device, n: int = 150, outliers: int = 10, seed: int = 2):
    """K3 inputs: world points, noisy unit bearings (a few outliers) and the
    valid mask; also the true pose (4×4)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -3, 6], [4, 3, 18], size=(n, 3))
    T_true = se3_np([0.05, -0.03, 0.08, 0.004, -0.006, 0.01])
    p_cam = pts @ T_true[:3, :3].T + T_true[:3, 3]
    brg = p_cam / np.linalg.norm(p_cam, axis=-1, keepdims=True)
    brg += rng.normal(0, 5e-4, size=brg.shape)
    brg[:outliers] += rng.normal(0, 0.05, size=(outliers, 3))
    brg /= np.linalg.norm(brg, axis=-1, keepdims=True)
    valid = np.ones(n, bool)
    valid[-3:] = False
    args = [torch.from_numpy(a).to(device) for a in (pts.astype(np.float32), brg.astype(np.float32), valid)]
    return args, T_true


def depth_problem(device, filters: int = 512, steps: int = 16, patch: int = 7, width: int = 1241,
                  height: int = 376, seed: int = 3):
    """K4 inputs: (filters·steps) windows of (patch+5) rows, zero-mean
    reference patches repeated per step, and the sub-pixel offsets."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 255, (height, width)).astype(np.float32))
    locs = torch.from_numpy(rng.uniform(20, [width - 20, height - 20], (filters * steps, 2)).astype(np.float32))
    ref = rng.uniform(0, 255, (filters, patch * patch)).astype(np.float32)
    win, org, _ = window_gather(img, locs, win_h=patch + 5)
    cref = torch.from_numpy(np.repeat(ref - ref.mean(-1, keepdims=True), steps, axis=0))
    return [t.contiguous().to(device) for t in (win, cref, locs - org)]


def _flat(out) -> List[torch.Tensor]:
    res = []
    for x in out:
        if isinstance(x, SE3):
            res += [x.rotation, x.translation]
        else:
            res.append(x)
    return res


def max_abs_err(got, want) -> float:
    """Largest |kernel − plain| over the float outputs; a boolean output
    that differs anywhere counts as infinite."""
    err = 0.0
    for g, w in zip(_flat(got), _flat(want)):
        if g.dtype == torch.bool:
            if not torch.equal(g, w):
                return float("inf")
        else:
            err = max(err, float((g.float() - w.float()).abs().max()))
    return err


# |kernel − plain| allowed per kernel: both are float32 with other summation
# orders (warp shuffles, FMA contraction); an LM that took another
# accept/reject branch would differ by far more. K4's scores are sums of 49
# absolute differences of values up to 255.
TOLERANCE = {"lm_align_level": 1e-3, "fa_align_batch": 1e-3, "pose_refine": 1e-3,
             "depth_scores": 5e-2}
# K2 runs N independent LMs whose stall test compares a relative decrease
# with 1e-3: a feature within float32 rounding of that edge freezes one step
# earlier in one of the two versions and lands one late LM step away
# (< 0.05 px). At most 3 % of the features may do so; flags stay equal.
FA_STEP_PX = 0.05
FA_FLIP_SHARE = 0.03


def agrees(name: str, got, want) -> Tuple[float, bool]:
    """(largest |kernel − plain|, whether the kernel agrees with its plain
    version within the stated tolerance of ``name``)."""
    base = name.split("[")[0]
    err = max_abs_err(got, want)
    if base != "fa_align_batch":
        return err, err <= TOLERANCE[base]
    uv_d = (got[0] - want[0]).abs().max(1).values
    rmse_d = (got[1] - want[1]).abs()
    same = (uv_d <= TOLERANCE[base]) & (rmse_d <= TOLERANCE[base])
    ok = (torch.equal(got[2], want[2]) and float(uv_d.max()) <= FA_STEP_PX
          and float((~same).float().mean()) <= FA_FLIP_SHARE)
    return err, ok


def median_ms(fn: Callable, runs: int = 20) -> float:
    """Median wall time of ``fn()`` followed by a device synchronisation."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_cases(device, sizes: Dict[str, int] = None) -> List[Tuple[str, Callable, Callable]]:
    """(name, kernel call, plain call) for each K1 level, K2, K3 and K4."""
    sizes = sizes or {}
    cases = []
    for lv, (args, its) in enumerate(lm_problems(device, n=sizes.get("lm", 256))):
        T0 = SE3.identity(device=device)
        kw = dict(max_iters=its, min_rel_decrease=2e-3)
        cases.append((f"lm_align_level[L{lv}]",
                      lambda a=args, kw=kw: lm_align.lm_align_level(T0, *a, **kw)[:2],
                      lambda a=args, kw=kw: lm_align.lm_align_level_plain(T0, *a, **kw)[:2]))
    fa_args = fa_problem(device, n=sizes.get("fa", 150))
    cases.append(("fa_align_batch", lambda: fa_align.fa_align_batch(*fa_args),
                  lambda: fa_align.fa_align_batch_plain(*fa_args)))
    p_args, _ = pose_problem(device, n=sizes.get("pose", 150))
    T0 = SE3.identity(device=device)
    cases.append(("pose_refine", lambda: pose_refine.pose_refine(T0, *p_args)[:2],
                  lambda: pose_refine.pose_refine_plain(T0, *p_args)[:2]))
    d_args = depth_problem(device, filters=sizes.get("depth_filters", 512))
    cases.append(("depth_scores", lambda: depth_scores.depth_scores(*d_args),
                  lambda: depth_scores.depth_scores_plain(*d_args)))
    return cases
