"""Kernel problems at main-path shapes and the kernel-vs-plain check.

Builds, from a seed, inputs for K1–K4 shaped as the main path hands them to
the kernels (a rendered textured plane, features on a grid, windows and
tables made by the port's own samplers), runs each hand-written kernel and
its plain PyTorch version on the same tensors, and reports the largest
disagreement and both times. ``batched_problems`` stacks S such problems (S
seeds) along a leading axis, as the multi-sequence path hands them to the
kernels' batched launches. Also the measuring tools: the wrapper's time
on the host clock (``median_ms``), the kernel's time on the device
(``device_ms``, against ``empty_launch``) and the least time the card could
take for the same work (``bound_ms``). ``chip_smoke.py`` runs it on the card
at the main path's sizes; the CPU tests build the same problems at small
sizes.
"""

from __future__ import annotations

import math
import statistics
import subprocess
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from scipy.linalg import expm

from sdvo_tpu_torch.dataio.synthetic import render_plane, smooth_texture
from sdvo_tpu_torch.geometry.se3 import SE3
from sdvo_tpu_torch.image.interp import padded_patch_and_gradients
from sdvo_tpu_torch.image.pyramid import abs_gradient_saturated_sum, build_pyramid
from sdvo_tpu_torch.ops import build, depth_scores, fa_align, lm_align, pose_refine
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
                seed: int = 0, patch: int = 5, iterations: int = None):
    """K1 inputs for every pyramid level: a list of (args, max_iters), args
    in ``lm_align_level`` order after ``T_init``. ``max_iters`` follows the
    device path's taper (10, 8, 6, 4 from the coarsest level down) unless
    ``iterations`` names one count for every level, as the host path does."""
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
        patches, gx, gy, ok_s = sample_windows_grad(win_r, uv_l - org_r, patch)
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
        out.append((args + [fx, fy, cx, cy], iterations or max(4, 10 - 2 * (levels - 1 - lv))))
    return out


def fa_problem(device, n: int = 150, width: int = 1241, height: int = 376, seed: int = 1,
               patch: int = 5, dead: bool = False, edge: bool = False):
    """K2 inputs: gradient windows (n, 24, 32) around perturbed positions,
    cached reference patch tables, origins and the live mask (the last two
    features dead where n > 2; all of them with ``dead``). With ``edge`` every
    third feature starts 11 px from its window's centre row, where the patch
    has no support in the window and the feature is invisible."""
    ref, cur, _ = plane_pair(seed, [0.012, -0.008, 0.0, 0.0, 0.0, 0.0], width, height)
    gref = abs_gradient_saturated_sum(torch.from_numpy(ref))
    gcur = abs_gradient_saturated_sum(torch.from_numpy(cur))
    rng = np.random.default_rng(seed)
    uv_ref = rng.uniform(40, [width - 40, height - 40], size=(n, 2)).astype(np.float32)
    table, gx, gy, ok = padded_patch_and_gradients(gref, torch.from_numpy(uv_ref), patch)
    uv_init = torch.from_numpy((uv_ref + rng.normal(0, 0.5, size=(n, 2))).astype(np.float32))
    win, org, ok_w = window_gather(gcur, uv_init, 24)
    if edge:
        uv_init[::3, 1] += 11.0
    live = ok & ok_w
    if n > 2:
        live[-2:] = False
    if dead:
        live[:] = False
    return [t.contiguous().to(device) for t in (win, table, gx, gy, uv_init, org, live)]


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
    if n > 3:
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


def device_ms(launch, runs: int = 100, warmup: int = 5) -> float:
    """Device-side time of one ``launch()``: ``runs`` back-to-back launches
    captured in one CUDA graph (so that no host gap sits between them),
    replayed between two CUDA events, ``elapsed_time`` over the count.
    ``launch`` may only enqueue kernels (no allocation, no host sync). Every
    launch works on the same buffers, so the inputs are warm in the L2 cache
    from the second launch on; given a list of launches (``cold_launches``)
    the graph takes them in turn."""
    launches = launch if isinstance(launch, list) else [launch]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(max(warmup, len(launches))):
            launches[i % len(launches)]()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(runs):
            launches[i % len(launches)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def card_line() -> str:
    """The card's name and power limit, as every measurement is labelled."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def empty_launch(device) -> Callable:
    """A launch of the kernel that does nothing (``csrc/empty.cu``): its
    ``device_ms`` is the floor under any one-launch kernel on the card."""
    fn = build.library().sdvo_empty_launch
    return lambda: build.check(fn(build.stream_ptr(device)), "empty_launch")


# ------------------------------------------------------------------- bounds
# Published peaks of one H100 SXM: device memory rate and float32 rate
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
L2_BYTES = 50 * 2 ** 20  # the card's L2 cache
# Operations the LM kernels' function needs per residual (float32 adds,
# multiplies and compares, a fused multiply-add as two), by the cheapest way
# to get the same numbers:
#   robust scale: min/max/count 3, four histogram stages of a 4-compare
#   search over the 16 thresholds and 1 add, deviation and its max 3, Tukey
#   weight and chi² 8 (the 16-add prefix sum of a stage is once a solve's
#   evaluation, _STAGE_FLOPS);
#   H/g: 6 for J·w, 2·27 for the sums, 6 for the weight.
_SCALE_FLOPS = 3 + 4 * 5 + 3 + 8
_STAGE_FLOPS = 4 * 16
_HG_FLOPS = 6 + 2 * 27 + 6
_BILINEAR_FLOPS = 12  # floor, two fractions, three lerps
# K2, per pixel. An evaluation (one before the loop, one an iteration): sample,
# residual 2, the robust scale once (min/max 2, two bisections of
# fa_align.BISECT_STEPS steps at a compare and an add each, deviation and its
# largest 3, Tukey weight and chi² 8). An iteration besides: w·gx and w·gy 2,
# the nine H/g sums at a multiply and an add, 6 for the solve's share. At the
# end: rmse 2, mean 2, variance 3 (the sample is the last evaluation's).
_FA_EVAL_FLOPS = _BILINEAR_FLOPS + 2 + 2 + 2 * 2 * fa_align.BISECT_STEPS + 3 + 8
_FA_HG_FLOPS = 2 + 2 * 9 + 6
_FA_FINAL_FLOPS = 2 + 2 + 3
_PROJECT_FLOPS = 24  # rotate, translate, divide, scale: once a feature


class Bound(NamedTuple):
    ms: float  # the larger of bytes / peak rate and operations / peak rate
    by: str  # "bytes" or "operations"
    bytes: int
    flops: int


def bound_ms(name: str, shapes: Dict[str, int], iterations: int = None) -> Bound:
    """The least time one H100 could take for one call of kernel ``name`` at
    ``shapes``: every input read once and every output written once at
    3.35 TB/s, or its float32 operations at 67 TFLOP/s, whichever is larger.
    ``shapes``: ``N``, ``WH``, ``WW``, ``P2`` (rows, window height and width,
    patch area; K3 takes ``N`` alone; K4 also ``win_bytes``, the window bytes
    its patches read, ``footprint_bytes``). ``iterations`` are the LM iterations
    the data needed (K1 and K3 report them; K2 is counted at 10, the most a
    feature can need: it is bound by bytes even then, so the features that
    stall earlier do not move its bound)."""
    base = name.split("[")[0]
    N = shapes["N"]
    if base == "pose_refine":
        nbytes = 4 * (N * 7 + 12 + 12 + 4)
        per_eval = N * (_PROJECT_FLOPS + 3 * (1 + _SCALE_FLOPS)) + _STAGE_FLOPS
        per_iter = N * 3 * (30 + _HG_FLOPS)  # 30: the Jacobian row (I − ffᵀ)/|p|·[I | −p̂]
        flops = (iterations + 1) * per_eval + iterations * per_iter
    else:
        WH, WW, P2 = shapes["WH"], shapes["WW"], shapes["P2"]
        if base == "lm_align_level":
            nbytes = 4 * (N * (WH * WW + P2 * 7 + 6) + 12 + 12 + 4)
            per_eval = (N * (_PROJECT_FLOPS + P2 * (_BILINEAR_FLOPS + 1 + _SCALE_FLOPS))
                        + _STAGE_FLOPS)
            flops = (iterations + 1) * per_eval + iterations * N * P2 * _HG_FLOPS
        elif base == "fa_align_batch":
            # the live mask and the converged flag are one byte each
            nbytes = 4 * N * (WH * WW + 3 * P2 + 4 + 3) + 2 * N
            its = iterations or 10
            flops = N * P2 * ((its + 1) * _FA_EVAL_FLOPS + its * _FA_HG_FLOPS + _FA_FINAL_FLOPS)
        elif base == "depth_scores":
            # of the windows only the 32-byte sectors the bilinear footprints
            # touch (``win_bytes``, counted from the offsets by
            # ``problem_shapes``); cref, offs and the two outputs whole
            nbytes = shapes["win_bytes"] + 4 * N * (P2 + 2 + 2)
            flops = N * P2 * (_BILINEAR_FLOPS + 1 + 2 + 3)  # sample, mean, centre, squared difference
        else:
            raise KeyError(name)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_F32_FLOPS * 1e3
    return Bound(max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations",
                 nbytes, flops)


_OPS = {  # base name: (module, wrapper, plain version, outputs compared)
    "lm_align_level": (lm_align, lm_align.lm_align_level, lm_align.lm_align_level_plain, 2),
    "fa_align_batch": (fa_align, fa_align.fa_align_batch, fa_align.fa_align_batch_plain, None),
    "pose_refine": (pose_refine, pose_refine.pose_refine, pose_refine.pose_refine_plain, 2),
    "depth_scores": (depth_scores, depth_scores.depth_scores, depth_scores.depth_scores_plain, None),
}


HOST_LM = "lm_align_level[host-"  # the names of K1's problems at the host path's shape


def kernel_problems(device, sizes: Dict[str, int] = None) -> List[Tuple[str, tuple, dict]]:
    """(name, arguments, keyword arguments) of each K1 level at the device
    path's shape (256 features, tapered iterations) and at the host path's
    (``System._sparse_align``: 512 features over two host images, 12
    iterations a level, exit at 1e-3), K2, K3 and K4, for the wrapper, its
    plain version and its ``kernel_launcher`` alike."""
    sizes = sizes or {}
    T0 = SE3.identity(device=device)
    problems = []
    for lv, (args, its) in enumerate(lm_problems(device, n=sizes.get("lm", 256))):
        problems.append((f"lm_align_level[L{lv}]", (T0, *args),
                         dict(max_iters=its, min_rel_decrease=2e-3)))
    for lv, (args, its) in enumerate(lm_problems(device, n=sizes.get("lm_host", 512), iterations=12)):
        problems.append((f"{HOST_LM}L{lv}]", (T0, *args), dict(max_iters=its, min_rel_decrease=1e-3)))
    problems.append(("fa_align_batch", tuple(fa_problem(device, n=sizes.get("fa", 150))), {}))
    problems.append(("pose_refine", (T0, *pose_problem(device, n=sizes.get("pose", 150))[0]), {}))
    problems.append(("depth_scores",
                     tuple(depth_problem(device, filters=sizes.get("depth_filters", 512))), {}))
    return problems


def extra_problems(device) -> List[Tuple[str, tuple, dict]]:
    """K1, K2 and K3 problems at the sizes their thread mappings make
    interesting: a feature count that is no multiple of a warp, more
    residuals than a block keeps in registers, patch 4, one observation,
    more observations than any register tier holds, and nothing visible
    (which must return the initial pose); for K2 one feature, a count that is
    no multiple of the warps of a block, patch 4 (half a warp), ten times the
    main path's count, every feature dead (``uv_init`` comes back) and
    features whose start has no patch support in the window."""
    T0 = SE3.identity(device=device)
    problems = []
    for tag, n, patch, blind in (("N37", 37, 5, False), ("N300", 300, 5, False),
                                 ("patch4", 64, 4, False), ("N37-blind", 37, 5, True)):
        args, _ = lm_problems(device, n=n, patch=patch)[0]
        if blind:
            args[5] = torch.zeros_like(args[5])
        problems.append((f"lm_align_level[{tag}]", (T0, *args),
                         dict(patch=patch, max_iters=10, min_rel_decrease=2e-3)))
    for tag, n, blind in (("N1", 1, False), ("N33", 33, False), ("N500", 500, False),
                          ("N1500", 1500, False), ("N33-blind", 33, True)):
        args, _ = pose_problem(device, n=n, outliers=n // 10)
        if blind:
            args[2] = torch.zeros_like(args[2])
        problems.append((f"pose_refine[{tag}]", (T0, *args), {}))
    for tag, n, patch in (("N1", 1, 5), ("N37", 37, 5), ("patch4", 64, 4), ("N1500", 1500, 5),
                          ("dead", 37, 5), ("edge", 37, 5)):
        args = fa_problem(device, n=n, patch=patch, dead=tag == "dead", edge=tag == "edge")
        problems.append((f"fa_align_batch[{tag}]", tuple(args), dict(patch=patch)))
    return problems


def batched_problems(device, S: int = 8, sizes: Dict[str, int] = None
                     ) -> List[Tuple[str, tuple, dict, List[tuple]]]:
    """(name, stacked arguments, keyword arguments, the S problems' own
    arguments) of each K1 level at the device path's shape, K2, K3 and K4:
    problem s is ``kernel_problems``'s built from seed s more (another
    texture, other features, points and windows), stacked along a new
    leading axis as ``torch.func.vmap`` hands them to the batched kernel."""
    sizes = sizes or {}
    T0 = SE3.identity((S,), device=device)
    per = [[] for _ in range(6)]  # (name, args, kw) of each K1 level, K2, K3, K4; a problem a seed
    for s in range(S):
        for lv, (args, its) in enumerate(lm_problems(device, n=sizes.get("lm", 256), seed=s)):
            per[lv].append((f"lm_align_level[S{S}-L{lv}]", (SE3.identity(device=device), *args),
                            dict(max_iters=its, min_rel_decrease=2e-3)))
        per[4].append(("fa_align_batch", tuple(fa_problem(device, n=sizes.get("fa", 150), seed=1 + s)), {}))
        per[5].append(("pose_refine", (SE3.identity(device=device),
                                       *pose_problem(device, n=sizes.get("pose", 150), seed=2 + s)[0]), {}))
    per.append([("depth_scores", tuple(depth_problem(device, filters=sizes.get("depth_filters", 512),
                                                     seed=3 + s)), {}) for s in range(S)])
    out = []
    for problems in per:
        name, _, kw = problems[0]
        if not name.startswith("lm_align_level"):
            name = f"{name}[S{S}]"
        stacked = tuple(T0 if isinstance(a, SE3) else
                        torch.stack([p[1][k] for p in problems]) if isinstance(a, torch.Tensor) else a
                        for k, a in enumerate(problems[0][1]))
        out.append((name, stacked, kw, [p[1] for p in problems]))
    return out


def batched_call(name: str, stacked: tuple, kw: dict) -> Callable:
    """The wrapper under ``torch.func.vmap`` over the leading axis of the
    tensor arguments (the floats go in as they are): on the card, one launch
    of the batched kernel. Cut to the outputs that are compared."""
    _, wrapper, _, n_out = _OPS[name.split("[")[0]]
    dims = tuple(None if isinstance(a, (int, float)) else 0 for a in stacked)
    return lambda: torch.func.vmap(lambda *a: wrapper(*a, **kw), in_dims=dims)(*stacked)[:n_out]


def pick(out, s: int) -> tuple:
    """Problem ``s`` of a batched call's outputs (``batched_call``)."""
    return tuple(SE3(x.rotation[s], x.translation[s]) if isinstance(x, SE3) else x[s] for x in out)


def problem_shapes(name: str, args: tuple) -> Dict[str, int]:
    """The ``shapes`` of ``bound_ms`` for a problem of ``kernel_problems``."""
    base = name.split("[")[0]
    if base == "pose_refine":
        return {"N": args[1].shape[0]}
    windows, table = (args[1], args[2]) if base == "lm_align_level" else (args[0], args[1])
    shapes = {"N": windows.shape[0], "WH": windows.shape[1], "WW": windows.shape[2],
              "P2": table.shape[1]}
    if base == "depth_scores":
        patch = math.isqrt(table.shape[1])
        shapes["win_bytes"] = footprint_bytes(args[2], patch, windows.shape[1], windows.shape[2])
    return shapes


def footprint_bytes(offs: torch.Tensor, patch: int, WH: int, WW: int, sector: int = 32) -> int:
    """The bytes K4 must read of its float32 windows (R, WH, WW): for each
    row, the ``sector``-byte sectors that its bilinear footprint touches —
    ``patch`` + 1 columns and rows from the floor of the patch's corner
    (``offs[r]`` less ``patch // 2``), cut to the window. A window starts on
    a sector (WH·WW·4 is a multiple of 32 at every shape the port runs)."""
    corner = torch.floor(offs.double().cpu() - patch // 2).long()  # (R, 2): x, y
    x0, x1 = corner[:, 0].clamp(0, WW - 1), (corner[:, 0] + patch).clamp(0, WW - 1)
    y0, y1 = corner[:, 1].clamp(0, WH - 1), (corner[:, 1] + patch).clamp(0, WH - 1)
    inside = ((corner[:, 0] + patch >= 0) & (corner[:, 0] < WW)
              & (corner[:, 1] + patch >= 0) & (corner[:, 1] < WH))
    h = torch.arange(WH)[None, :]  # every window row; those of the footprint count
    touched = (h >= y0[:, None]) & (h <= y1[:, None]) & inside[:, None]
    first = (h * WW + x0[:, None]) * 4 // sector
    last = ((h * WW + x1[:, None]) * 4 + 3) // sector
    return int(((last - first + 1) * touched).sum()) * sector


def case_calls(name: str, args: tuple, kw: dict) -> Tuple[Callable, Callable]:
    """(kernel call, plain call) of one problem: the wrapper and its plain
    version on the same arguments, cut to the outputs that are compared."""
    _, wrapper, plain, n_out = _OPS[name.split("[")[0]]
    return (lambda: wrapper(*args, **kw)[:n_out]), (lambda: plain(*args, **kw)[:n_out])


def kernel_cases(device, sizes: Dict[str, int] = None) -> List[Tuple[str, Callable, Callable]]:
    """(name, kernel call, plain call) for each K1 level, K2, K3 and K4."""
    return [(name, *case_calls(name, args, kw)) for name, args, kw in kernel_problems(device, sizes)]


def kernel_launcher(name: str, args: tuple, kw: dict):
    """(launch, output tensors) of a problem of ``kernel_problems``:
    ``launch()`` enqueues the kernel alone (card only). K1 and K3 give
    (out_pose (3, 4), out_stats = [chi², n_vis, iterations, 0]), K2 (uv, rmse,
    converged), K4 (score, ok)."""
    launch, *outs = _OPS[name.split("[")[0]][0].kernel_launcher(*args, **kw)
    return launch, tuple(outs)


def cold_launches(name: str, args: tuple, kw: dict, nbytes: int) -> List[Callable]:
    """Launches of the problem on copies of its tensors, as many as together
    hold twice the L2 cache and at least two (``nbytes``: what one call
    moves): taken in turn, each finds its inputs in device memory, not in
    the cache, which is what ``bound_ms`` assumes of every byte."""
    copies = max(2, -(-2 * L2_BYTES // nbytes))
    clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a  # noqa: E731
    return [kernel_launcher(name, tuple(clone(a) for a in args), kw)[0] for _ in range(copies)]
