"""How ``correct`` is decided: the timed path's outputs against two
witnesses that the program does not share, the scene's truth and the plain
reference (``benchmark/reference``, or the package a configuration's
``reference`` names: the port's superstep and the packing of its start,
frozen as plain PyTorch and run eagerly in float32 with TF32 off, with no
kernel, no CUDA graph and no vmap).

**Every frame of the window, against the scene's truth** (``window_numbers``,
from each stream's emitted ``trajectory`` and ``metrics``): on this scene
every frame tracks, and one frame a superstep (its last) is a keyframe, as
bench.py's gates state.

**Sampled supersteps, against the reference.** The program's state lives on
the device and a dispatch runs inside one graph, so the reference follows
the program from the program's own state:

* **the supersteps**: for each dispatch of the window that the seed draws
  (``check.dispatches`` of them), the reference runs the first
  ``check.supersteps`` supersteps of that dispatch from the state the
  dispatch started from, on the same 8-bit frames, and every frame's outputs
  as the program emitted them (pose, ok, keyframe, matches, points, filters,
  alignment rmse) are compared with the reference's. In a joint chunk every
  sequence is compared in its own slot. The state's frame counter must be
  the index of the dispatch's first frame.
* **the start**: the device state the dispatches start from is what
  ``DeviceSystem._pack`` made of the host state after the two-view
  bootstrap. The reference packs the same host state (a copy taken right
  after the bootstrap) through its own ``pack`` and the two device states
  are compared leaf by leaf (``check.starts`` streams, drawn from the seed).
  The two-view bootstrap itself is not reproduced.

The numbers compared, each with its limit (``check.limits`` of the cell's
traffic file); a number above its limit, or not finite, makes the run
incorrect:

``rmse_gap_group_median`` the largest median, over the compared frames of
                  one stream and over those of one kind (tracked frames,
                  keyframes; every stream's), of the gap between the
                  program's and the reference's alignment rmse (grey levels;
                  a frame that one side failed counts as an infinite gap): a
                  fault in one stream of eight, or in the keyframes alone,
                  moves one group's median
``flag_gap``      compared frames whose ok or keyframe flag differs from the
                  reference's (exact: limit 0)
``start_gap``     largest gap between a floating leaf of the two packed
                  starts, over that leaf's largest magnitude in the reference
``frame_id_gap``  largest gap between a sampled state's frame counter and
                  its dispatch's first frame (exact: limit 0)
``failed_frames`` frames of the window that the program failed (limit 0)
``keyframe_gap``  frames of the window whose keyframe flag differs from the
                  cadence (limit 0)

Printed beside them and not compared, because the program's own departures
from the reference (an LM that stops one iteration earlier, a depth filter
that converges a frame later) reach the control's on some seeds even as
group medians (PERF.md, §6): ``pose_gap_group_median`` (camera centres, map
units), ``rot_gap_group_median`` (rad) and ``count_gap_group_median``
(matches, points or filters), the largest ``pose_gap``, ``rot_gap``,
``rmse_gap`` and ``count_gap``, ``start_mismatch`` (integer and boolean
elements of the two starts that differ); and against the truth ``drift``
and ``ate_m`` (the largest stream's scale-aligned ATE over its path, and in
the truth's metres), because on this scene's oscillating path a stream half
of whose poses are those of frames half a period away reads no more than
sound runs do.

``control=True`` puts the reference in the program's place at the nearest
precision below the configuration's float32 with TF32 off: float32 with
every matrix product's inputs rounded to TF32's 10-bit mantissa (``TF32``;
sums in float32, as the card's TF32 mode does), on any device.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

import numpy as np

from benchmark.harness import spec

# compared, each with its limit: against the reference, then against the truth
NUMBERS = ("rmse_gap_group_median", "flag_gap", "start_gap", "frame_id_gap", "failed_frames", "keyframe_gap")
WINDOW = ("failed_frames", "keyframe_gap", "drift", "ate_m")  # of every frame of the window
INFO = ("pose_gap_group_median", "rot_gap_group_median", "count_gap_group_median", "pose_gap", "rot_gap",
        "rmse_gap", "count_gap", "start_mismatch", "drift", "ate_m")  # printed only


# --------------------------------------------------------------- the control
def round_tf32(x):
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits), nearest."""
    import torch

    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def TF32():
    """A ``TorchFunctionMode`` that rounds the float32 inputs of every matrix
    product (``@``, ``matmul``, ``mm``, ``bmm``, ``einsum``) to TF32."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_map

    ops = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
           torch.mm, torch.Tensor.mm, torch.bmm, torch.Tensor.bmm, torch.einsum}

    class _TF32(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in ops:
                args = tree_map(round_tf32, args)
            return func(*args, **kwargs)

    return _TF32()


# ----------------------------------------------------------- the reference
def to_reference(x, dtype, classes):
    """A tree of the program's state as the reference's: the same fields in
    the reference's ``classes`` (by name), floating tensors in
    ``dtype``, the rest copied."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return classes[type(x).__name__](*[to_reference(v, dtype, classes) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(to_reference(v, dtype, classes) for v in x)
    if isinstance(x, dict):
        return {k: to_reference(v, dtype, classes) for k, v in x.items()}
    return x


class Reference:
    """The reference in ``dtype`` (the configuration's float32) for a
    configuration's ``settings`` and camera (``scene.camera``: intrinsics,
    size and distortion) on ``device``, from the reference package named
    ``package`` (the configuration's ``reference``: a dotted name, whose
    ``__all__`` is ``benchmark.reference``'s); with ``tf32`` the control,
    whose matrix products round their inputs to TF32."""

    def __init__(self, settings: dict, cam, device, dtype: str = "float32", tf32: bool = False,
                 package: str = spec.DEFAULT_REFERENCE):
        import importlib

        import torch

        self.ref = importlib.import_module(package)
        self.classes = {c.__name__: c for c in self.ref.STATE_CLASSES}
        sections = {k: dict(v) for k, v in settings.items() if isinstance(v, dict)}
        self.config = self.ref.load_config(overrides=sections).replace(compute_dtype=dtype)
        self.cam = cam
        self.device = torch.device(device)
        self.dtype = getattr(torch, dtype)
        self.tf32 = tf32
        self._vo = None

    def _mode(self):
        import contextlib

        return TF32() if self.tf32 else contextlib.nullcontext()

    @property
    def vo(self):
        """The reference's ``DeviceVO`` (built once), with the configuration's
        superstep sizes and ``DeviceSystem``'s defaults."""
        if self._vo is None:
            c = self.cam
            cam = self.ref.PinholeCamera.create(c.fx, c.fy, c.cx, c.cy, c.width, c.height, dist=c.dist,
                                                dtype=self.dtype)
            self._vo = self.ref.DeviceVO(cam, self.ref.superstep_config(self.config), dtype=self.dtype)
        return self._vo

    def follow(self, state, frames: List[np.ndarray]) -> List[dict]:
        """The outputs of the supersteps over ``frames`` (8-bit, a whole
        number of supersteps) from the program's ``state``: one dict a
        frame."""
        import torch

        vo = self.vo
        per = vo.cfg.period
        st = to_reference(state, self.dtype, self.classes)
        out = []
        with torch.no_grad(), self.ref.deterministic_on(self.device), self._mode():
            for k in range(len(frames) // per):
                imgs = torch.as_tensor(np.stack(frames[k * per:(k + 1) * per]).astype(np.float32),
                                       device=self.device).to(self.dtype)
                st, fo = vo.superstep(st, imgs)
                fo = [x.cpu().numpy() for x in fo]
                out += [frame_from_ref(fo, p) for p in range(per)]
        return out

    def repack(self, snap: dict):
        """The reference's ``pack`` of a host snapshot (``host_snapshot``):
        its packed device state."""
        import types

        import torch

        def mine(x):
            return to_reference(x, self.dtype, self.classes)

        host = types.SimpleNamespace(
            arena=types.SimpleNamespace(**mine(snap["arena"])), filters=mine(snap["filters"]),
            ref_frame=types.SimpleNamespace(**mine(snap["ref_frame"])),
            prev_rel=snap["prev_rel"], frame_count=snap["frame_count"], height=snap["height"],
            width=snap["width"])
        with torch.no_grad(), self._mode():
            return self.ref.pack(host, self.vo, self.device)


def host_snapshot(host) -> dict:
    """What ``DeviceSystem._pack`` reads of a host ``System``, copied (tensors
    cloned): taken right after the bootstrap, before anything can change
    it."""
    import copy

    return copy.deepcopy({"arena": dict(host.arena.__dict__), "filters": host.filters,
                          "ref_frame": dict(host.ref_frame.__dict__), "prev_rel": host.prev_rel,
                          "frame_count": host.frame_count, "height": host.height, "width": host.width})


# ------------------------------------------------------------- the numbers
def frame_from_ref(fo, p: int) -> dict:
    """One frame of the reference's ``FrameOut`` (numpy, a superstep's)."""
    R = np.asarray(fo[0][p], np.float64)
    t = np.asarray(fo[1][p], np.float64)
    ok = bool(fo[2][p])
    return {"ok": ok, "kf": bool(fo[3][p]) and ok, "R": R, "t": t, "rmse": float(fo[4][p]),
            "n_matches": int(fo[5][p]), "n_filters": int(fo[6][p]), "n_points": int(fo[7][p])}


def frame_from_program(T, m: dict) -> dict:
    """One frame as the program emitted it: ``trajectory[j]`` and
    ``metrics[j]``."""
    ok = T is not None and m["result"] != "FAILED"
    R = np.asarray(T, np.float64)[:3, :3] if T is not None else None
    t = np.asarray(T, np.float64)[:3, 3] if T is not None else None
    return {"ok": ok, "kf": m["result"] == "KEYFRAME", "R": R, "t": t, "rmse": float(m["align_rmse"]),
            "n_matches": int(m["n_features"]), "n_filters": int(m["n_filters"]), "n_points": int(m["n_points"])}


def rot_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle between two rotations, from the chord ‖Ra − Rb‖ (well
    conditioned near 0, where the trace's arccos is not)."""
    chord = np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0))
    return float(2.0 * np.arcsin(min(chord, 1.0)))


GAPS = ("pose", "rot", "rmse", "count")  # the per-frame gaps of ``per_frame``, in its columns


def per_frame(a: List[dict], b: List[dict]) -> List[List[float]]:
    """Each paired frame's [pose gap, rotation gap, rmse gap, count gap (the
    largest of matches, points, filters), flag differs] (the first three
    infinite where one side failed, nan where both did)."""
    rows = []
    for x, y in zip(a, b):
        both = x["ok"] and y["ok"]
        gone = float("nan") if not (x["ok"] or y["ok"]) else float("inf")
        rows.append([
            float(np.linalg.norm(-x["R"].T @ x["t"] + y["R"].T @ y["t"])) if both else gone,
            rot_angle(x["R"], y["R"]) if both else gone, abs(x["rmse"] - y["rmse"]) if both else gone,
            float(max(abs(x[k] - y[k]) for k in ("n_matches", "n_points", "n_filters"))),
            float(x["ok"] != y["ok"] or x["kf"] != y["kf"])])
    return rows


def frame_numbers(groups: Dict[tuple, List[List[float]]]) -> Dict[str, float]:
    """The compared and printed numbers of the paired frames: ``groups`` maps
    each frame's groups ((``"stream"``, k) and (``"kind"``, keyframe or not))
    to their ``per_frame`` rows; a frame is in one group of each."""
    rows = np.asarray([r for key, rs in groups.items() if key[0] == "stream" for r in rs], np.float64).reshape(-1, 5)
    nums = {"flag_gap": float(rows[:, 4].sum())}
    for col, gap in enumerate(GAPS):
        v = rows[:, col]
        v = v[~np.isnan(v)]
        nums[f"{gap}_gap"] = float(v.max()) if len(v) else 0.0
        medians = [np.median(c[~np.isnan(c)]) for c in (np.asarray(rs, np.float64)[:, col] for rs in groups.values())
                   if (~np.isnan(c)).any()]
        nums[f"{gap}_gap_group_median"] = float(max(medians)) if medians else 0.0
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in nums.items()}


def window_numbers(w) -> Dict[str, float]:
    """The window's numbers against the scene's truth (``WINDOW``), from a
    finished window (``drive.Window``): every stream's frames in the window,
    and its whole trajectory for the drift and the ATE (the largest
    stream's)."""
    from benchmark.harness import gates

    per = w.period
    failed = keyframe = 0
    drift, ate = 0.0, 0.0
    for k, (a, b) in enumerate(w.window_frames):
        for j in range(a, b):
            ok = w.trajectories[k][j] is not None and w.metrics[k][j]["result"] != "FAILED"
            failed += not ok
            keyframe += (w.metrics[k][j]["result"] == "KEYFRAME") != ((j - a) % per == per - 1)
        acc = gates.accuracy(w.trajectories[k][:b], [w.rings[k].truth(j) for j in range(b)])
        bad = acc["drift"] is None or not math.isfinite(acc["drift"])
        drift = float("inf") if bad else max(drift, acc["drift"])
        ate = float("inf") if bad else max(ate, acc["ate_m"])
    return {"failed_frames": float(failed), "keyframe_gap": float(keyframe), "drift": drift, "ate_m": ate}


def leaves(x) -> list:
    """The tensor leaves of a state tree, in order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in leaves(v)]
    return []


def start_gaps(prog, ref) -> Dict[str, float]:
    """``start_gap`` and ``start_mismatch`` between two packed states."""
    gap, mismatch = 0.0, 0.0
    for p, r in zip(leaves(prog), leaves(ref)):
        p, r = p.detach().cpu(), r.detach().cpu()
        if p.shape != r.shape:
            return {"start_gap": float("inf"), "start_mismatch": float("inf")}
        if r.is_floating_point():
            scale = float(r.double().abs().max()) if r.numel() else 0.0
            d = float((p.double() - r.double()).abs().max()) if r.numel() else 0.0
            gap = max(gap, d / max(scale, 1e-12) if d > 0 else 0.0)
        else:
            mismatch += float((p.long() != r.long()).sum())
    return {"start_gap": gap if math.isfinite(gap) else float("inf"), "start_mismatch": mismatch}


# ------------------------------------------------------------------- check
class Compared:
    """The program's outputs that a check compares, taken from a finished
    window (``drive.Window``) before the system is dropped: for each sampled
    dispatch and stream, (stream, state, first frame index, state's frame
    counter, frames, program's outputs); the starts of the streams the seed
    draws; and the window's numbers against the truth (``window``)."""

    def __init__(self, w, traffic: dict, seed: int):
        import torch

        chk = traffic["check"]
        m = int(chk["supersteps"])
        per = w.period
        self.per = per
        self.steps = []
        for state, first in w.samples.items:
            firsts = first if isinstance(first, list) else [first]
            for k, f in enumerate(firsts):
                st = state if w.streams == 1 else _slot(state, k)
                ring = w.rings[k]
                have = (len(w.trajectories[k]) - f) // per * per  # whole supersteps emitted
                js = range(f, f + min(m * per, have))
                frames = [np.array(ring.frame(j)) for j in js]
                prog = [frame_from_program(w.trajectories[k][j], w.metrics[k][j]) for j in js]
                fid = int(st.frame_id.item()) if isinstance(st.frame_id, torch.Tensor) else int(st.frame_id)
                self.steps.append((k, st, f, fid, frames, prog))
        rng = random.Random(seed)
        picks = sorted(rng.sample(range(len(w.starts)), min(int(chk["starts"]), len(w.starts))))
        self.starts = [(k, w.starts[k][0], w.starts[k][1]) for k in picks]
        self.window = window_numbers(w)


def _slot(state, k: int):
    """Sequence ``k``'s state from a stacked one."""
    import torch

    def take(x):
        if isinstance(x, torch.Tensor):
            return x[k]
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[take(v) for v in x])
        if isinstance(x, (tuple, list)):
            return type(x)(take(v) for v in x)
        return x

    return take(state)


def readings(cmp: Compared, ref: Reference, ref_outputs: Optional[list] = None,
             start_ref: Optional[list] = None, against: Optional[Reference] = None) -> Dict[str, float]:
    """Every number of the check, compared (``NUMBERS``) and printed
    (``INFO``). With ``against`` (the control), the control's outputs stand
    in the program's place and are compared with ``ref``'s (``ref_outputs``
    / ``start_ref``, reused where given); a ``cmp`` without ``window``
    leaves the window's numbers out."""
    nums = {k: 0.0 for k in NUMBERS + INFO if k not in WINDOW}
    outs = ref_outputs if ref_outputs is not None else [ref.follow(s[1], s[4]) for s in cmp.steps]
    groups: Dict[tuple, List[List[float]]] = {}
    for (k, st, first, fid, frames, prog), r in zip(cmp.steps, outs):
        mine = prog if against is None else against.follow(st, frames)
        for i, row in enumerate(per_frame(mine, r)):
            groups.setdefault(("stream", k), []).append(row)
            groups.setdefault(("kind", i % cmp.per == cmp.per - 1), []).append(row)
        nums["frame_id_gap"] = max(nums["frame_id_gap"], float(abs(fid - first)))
    if groups:
        nums.update(frame_numbers(groups))
    packed = start_ref if start_ref is not None else [ref.repack(snap) for _, _, snap in cmp.starts]
    for (k, state, snap), rstate in zip(cmp.starts, packed):
        mine = state if against is None else against.repack(snap)
        for key, v in start_gaps(mine, rstate).items():
            nums[key] = max(nums[key], v)
    if getattr(cmp, "window", None) is not None:
        nums.update(cmp.window)
    return nums


def limits(cell) -> Dict[str, float]:
    """A cell's limits: its traffic file's ``check.limits``."""
    return dict(cell.traffic["check"]["limits"])


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit, in ``NUMBERS``' order."""
    return {k: {"value": nums[k], "limit": limits[k]} for k in NUMBERS if k in limits and k in nums}


def correct(judged: Dict[str, dict], n_compared: int) -> bool:
    return n_compared > 0 and all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in judged.values())
