"""The window: the port's product path driven closed-loop by the scene's
frames for a number of seconds, in whole dispatches.

Two systems, by the configuration's ``system``:

* ``device_system``: one stream through ``DeviceSystem.add_image``
  (``supersteps_per_chunk`` from the cell's traffic), bootstrapped by
  ``add_image`` on frames 0, 1, … and then handed every frame back to back;
  a dispatch is the ``add_image`` call whose frame fills the buffer, or a
  frame the host ``System`` relocalizes on.
* ``multi_seq``: ``n_seq`` streams through ``MultiSequenceSystem``:
  ``bootstrap`` and then ``joint`` once a chunk, each call over lazy
  sequences one chunk longer than the last.

Set-up is everything up to the window: the scene, the system, the
bootstrap and one warm-up dispatch (the CUDA graph's capture). The window
starts after it and ends when the first dispatch to end after ``seconds``
returns. A traced run (``trace``) also records the harness's spans around
the calls into each layer, the launches' shapes during the warm-up, and a
``torch.profiler`` trace of ``trace.dispatches`` dispatches after
``trace.skip``.
"""

from __future__ import annotations

import gc
import random
import time
from types import SimpleNamespace
from typing import List

from benchmark import scene as scene_mod
from benchmark.harness import check
from benchmark.harness import trace as trace_mod
from benchmark.harness.roofline import LaunchShapes

BOOTSTRAP_FRAMES = 30  # a stream that has not bootstrapped by then is broken


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``
    (Vitter's algorithm R): the same seed and offers keep the same items."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: List = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


class Lazy:
    """A stream's frames as a sequence of ``stop`` frames that indexes its
    ring: ``seq[i]`` is frame i, ``seq[a:b]`` a list of them (views)."""

    def __init__(self, ring: scene_mod.Ring, stop: int = 10 ** 9):
        self.ring = ring
        self.stop = stop

    def __len__(self):
        return self.stop

    def __getitem__(self, k):
        if isinstance(k, slice):
            return [self.ring.frame(j) for j in range(*k.indices(self.stop))]
        return self.ring.frame(k)


class Spans:
    """The harness's host spans: seconds by name."""

    def __init__(self):
        self.seconds = {}

    def add(self, name: str, s: float):
        self.seconds[name] = self.seconds.get(name, 0.0) + s


class GCWatch:
    """The collector's passes inside the window, by generation: how many and
    their seconds (a diagnostic printed beside every run)."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_config(settings: dict):
    """The port's ``Config`` of a configuration file's ``settings``: the
    sections through ``load_config``'s overrides, ``compute_dtype`` set on
    the result (``load_config`` takes an override's value for a section)."""
    from sdvo_tpu_torch.config import load_config

    sections = {k: v for k, v in settings.items() if isinstance(v, dict)}
    return load_config(overrides=sections).replace(compute_dtype=settings["compute_dtype"])


# the camera the port's ``System`` takes when it is given none: these intrinsics at the configuration's
# ``settings.camera`` size, without distortion (``sdvo_tpu_torch/pipeline/system.py``)
PORT_DEFAULT_INTRINSICS = (721.5377, 721.5377, 609.5593, 172.854)


def port_camera(cam, config):
    """The port's camera for ``cam`` (``scene.camera``: intrinsics, size and
    distortion) under the port's ``config``: None where every field is the
    system's default camera's, so the system builds its own."""
    if ((cam.fx, cam.fy, cam.cx, cam.cy) == PORT_DEFAULT_INTRINSICS and not any(cam.dist)
            and (cam.width, cam.height) == (config.camera.img_width, config.camera.img_height)):
        return None
    import torch

    from sdvo_tpu_torch.geometry.camera import PinholeCamera

    dtype = torch.float32 if config.compute_dtype == "float32" else torch.float64
    return PinholeCamera.create(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, dist=cam.dist, dtype=dtype)


class Window:
    """What a run measured and kept for the check: ``t0``/``t_end`` (host
    clock), ``frames`` and ``supersteps`` completed (every stream's),
    ``latency_s`` (each dispatch's call), ``spans``, ``capture_s``,
    ``slice`` (the traced slice or None), ``launches`` (recorded shapes),
    ``samples`` (the check's sampled dispatches), ``starts`` (each stream's
    bootstrap state and host snapshot), ``trajectories``/``metrics`` (each
    stream's emitted outputs), ``rings``, ``period``, ``streams``,
    ``marks`` ((return time, frames done) of each dispatch) and ``gc`` (the
    collector's passes inside the window, a ``GCWatch``)."""


def run_window(cell, seed: int, seconds: float, trace: bool, device, cam=None, texture_size=None,
               fault=None) -> Window:
    """Set-up and the window of ``cell`` (a ``spec.Cell``) on ``device``, at
    the camera and in the scene of its configuration's file. ``cam`` /
    ``texture_size``: the CPU rehearsal's smaller scene (the file's camera
    scaled, ``scene.camera(block, scale)``, and a smaller texture).
    ``fault``, a test's hook, gets the system before the warm-up
    dispatch."""
    import torch

    device = torch.device(device)
    cfg = cell.config
    traffic = cell.traffic
    sc = scene_mod.Scene.of(cfg["scene"])
    cam = cam or scene_mod.camera(cfg["camera"])
    n_seq = int(cfg.get("n_seq", 1))
    rings = [scene_mod.build_ring(seed * n_seq + k if n_seq > 1 else seed, device, cam, sc, texture_size)
             for k in range(n_seq)]
    _sync(device)
    if device.type == "cuda":  # the device peak is the system's, not the renderer's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    config = port_config(cfg["settings"])
    camera = port_camera(cam, config)
    w = Window()
    w.rings, w.streams, w.spans = rings, n_seq, Spans()
    w.slice, w.launches = None, None
    w.samples = Reservoir(int(traffic["check"]["dispatches"]), seed)
    if cell.system == "device_system":
        _stream(w, cell, config, camera, rings[0], seconds, trace, device, fault)
    else:
        _joint(w, cell, config, camera, rings, seconds, trace, device, fault)
    return w


def _profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    return profile(activities=acts)


class _Tracer:
    """The traced slice: opens the profiler after ``skip`` dispatches of the
    window and closes it ``n`` dispatches later."""

    def __init__(self, traffic: dict, on: bool):
        tr = traffic.get("trace", {})
        self.on = on
        self.skip, self.n = int(tr.get("skip", 1)), int(tr.get("dispatches", 1))
        self.done = 0
        self.prof = self.rng = self.result = None
        self.frames = self.supersteps = 0

    @property
    def active(self) -> bool:
        return self.prof is not None

    def before(self):
        import torch

        if self.on and self.prof is None and self.done == self.skip:
            self.prof = _profiler()
            self.prof.__enter__()
            self.rng = torch.profiler.record_function(trace_mod.HOST_PREFIX + "slice")
            self.rng.__enter__()

    def after(self, device, frames: int, supersteps: int) -> bool:
        """Counts a dispatch; closes the slice after its last. Returns whether
        the dispatch was inside the slice."""
        inside = self.prof is not None
        self.done += 1
        if inside:
            self.frames += frames
            self.supersteps += supersteps
            if self.done == self.skip + self.n:
                _sync(device)
                self.rng.__exit__(None, None, None)
                self.prof.__exit__(None, None, None)
                self.result = self.prof
                self.prof = None
                self.on = False
        return inside

    def slice(self):
        if self.result is None:
            return None
        return trace_mod.from_profiler(self.result, "slice", self.frames, self.supersteps)


def _rf(name: str, trace: bool):
    import contextlib

    import torch

    return torch.profiler.record_function(trace_mod.HOST_PREFIX + name) if trace else contextlib.nullcontext()


def _stream(w, cell, config, camera, ring, seconds, trace, device, fault):
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem

    S = int(cell.traffic["supersteps_per_chunk"])
    ds = DeviceSystem(config, camera=camera, supersteps_per_chunk=S, device=device, seed=0)
    per = ds.scfg.period
    w.period = per
    i = 0
    while not ds.bootstrapped:
        if i >= BOOTSTRAP_FRAMES:
            raise RuntimeError(f"no bootstrap in {BOOTSTRAP_FRAMES} frames")
        ds.add_image(ring.frame(i), float(i))
        i += 1
    w.starts = [(ds.state, check.host_snapshot(ds.host))]
    if fault is not None:
        fault(ds)
    shapes = LaunchShapes() if trace else None
    try:
        for _ in range(S * per):  # the warm-up dispatch: the capture
            ds.add_image(ring.frame(i), float(i))
            i += 1
        _sync(device)
    finally:
        if shapes is not None:
            shapes.close()
    w.launches = shapes.calls if shapes is not None else None
    graph = getattr(ds.vo, "chunk_graph", None)
    last = getattr(graph, "last", None)
    w.capture_s = getattr(last, "capture_seconds", None)

    run_chunk = ds.vo.run_chunk
    chunk_s = [0.0]

    def timed_run_chunk(state, images):
        t = time.perf_counter()
        out = run_chunk(state, images)
        if trace:
            _sync(device)
        chunk_s[0] += time.perf_counter() - t
        return out

    ds.vo.run_chunk = timed_run_chunk
    tracer = _Tracer(cell.traffic, trace)
    lat, frames0 = [], len(ds.trajectory)
    n_in, boundary = 0, True  # frames of the traced slice; whether the last call emitted
    gc.collect()
    w.marks, w.gc = [], GCWatch()
    try:
        w.gc.__enter__()
        w.t0 = t0 = time.perf_counter()
        while True:
            before, n0 = ds.state, len(ds.trajectory)
            if boundary:
                tracer.before()
            active = tracer.active
            chunk_s[0] = 0.0
            with _rf("add_image", active):
                t = time.perf_counter()
                ds.add_image(ring.frame(i), float(i))
                t_ret = time.perf_counter()
            i += 1
            made = len(ds.trajectory) - n0
            if not active:
                w.spans.add("add_image", t_ret - t)
                w.spans.add("run_chunk", chunk_s[0])
            boundary = made > 0
            if not made:
                continue
            lat.append(t_ret - t)
            w.marks.append((t_ret, len(ds.trajectory) - frames0))
            if tracer.after(device, made, made // per if before is not None else 0):
                n_in += made
            if before is not None and made == S * per:
                w.samples.offer((before, i - made))
            if t_ret - t0 >= seconds:
                break
        w.t_end = t_ret
    finally:
        w.gc.__exit__()
        del ds.vo.run_chunk
    w.frames = len(ds.trajectory) - frames0
    w.supersteps = w.frames // per
    w.frames_spanned = w.frames - n_in
    w.latency_s = lat
    w.slice = tracer.slice()
    w.trajectories = [ds.trajectory]
    w.metrics = [ds.metrics]
    w.window_frames = [(frames0, len(ds.trajectory))]


def _joint(w, cell, config, camera, rings, seconds, trace, device, fault):
    from sdvo_tpu_torch.parallel.multi_seq import MultiSequenceSystem

    n = len(rings)
    ms = MultiSequenceSystem(config, n_seq=n, camera=camera, device=device,
                             supersteps_per_chunk=int(cell.traffic["supersteps_per_chunk"]))
    per = ms.period
    chunk = ms.supersteps_per_chunk * per
    w.period = per
    seqs = [Lazy(r, BOOTSTRAP_FRAMES) for r in rings]
    ms.bootstrap(seqs)
    subs = ms.subs
    w.starts = [(s.state, check.host_snapshot(s.host)) for s in subs]
    if fault is not None:
        fault(ms)

    chunk_fn = ms.chunk_fn
    seen = {}

    def wrapped(state, images):
        seen["state"] = state
        t = time.perf_counter()
        out = chunk_fn(state, images)
        if trace:
            _sync(device)
        seen["s"] = time.perf_counter() - t
        return out

    for attr in ("graph", "eager"):
        if hasattr(chunk_fn, attr):
            setattr(wrapped, attr, getattr(chunk_fn, attr))

    def one_chunk():
        for s, sub in zip(seqs, subs):
            s.stop = len(sub.trajectory) + chunk
        first = [len(sub.trajectory) for sub in subs]
        t = time.perf_counter()
        ms.joint(seqs)
        t_ret = time.perf_counter()
        made = sum(len(sub.trajectory) for sub in subs) - sum(first)
        if made != n * chunk:
            raise RuntimeError(f"a joint call emitted {made} frames, not {n * chunk}")
        return first, t_ret - t, t_ret

    shapes = LaunchShapes(batch=n) if trace else None
    ms.chunk_fn = wrapped
    try:
        try:
            one_chunk()  # the warm-up chunk: the capture
            _sync(device)
        finally:
            if shapes is not None:
                shapes.close()
        w.launches = shapes.calls if shapes is not None else None
        last = getattr(getattr(chunk_fn, "graph", None), "last", None)
        w.capture_s = getattr(last, "capture_seconds", None)
        tracer = _Tracer(cell.traffic, trace)
        frames0 = [len(s.trajectory) for s in subs]
        lat, n_in = [], 0
        gc.collect()
        w.marks, w.gc = [], GCWatch().__enter__()
        w.t0 = t0 = time.perf_counter()
        while True:
            tracer.before()
            seen.clear()
            with _rf("joint", tracer.active):
                first, dt, t_ret = one_chunk()
            lat.append(dt)
            w.marks.append((t_ret, sum(len(s.trajectory) for s in subs) - sum(frames0)))
            inside = tracer.after(device, n * chunk, n * ms.supersteps_per_chunk)
            if not inside:
                w.spans.add("joint", dt)
                w.spans.add("chunk_fn", seen["s"])
            else:
                n_in += n * chunk
            w.samples.offer((seen["state"], first))
            if t_ret - t0 >= seconds:
                break
        w.t_end = t_ret
    finally:
        if getattr(w, "gc", None) is not None:
            w.gc.__exit__()
        ms.chunk_fn = chunk_fn
    w.frames = sum(len(s.trajectory) for s in subs) - sum(frames0)
    w.supersteps = w.frames // per
    w.frames_spanned = w.frames - n_in
    w.latency_s = lat
    w.slice = tracer.slice()
    w.trajectories = [s.trajectory for s in subs]
    w.metrics = [s.metrics for s in subs]
    w.window_frames = [(f0, len(s.trajectory)) for f0, s in zip(frames0, subs)]


def run_record(w: Window, cell) -> SimpleNamespace:
    """What the per-layer readers read: plain numbers and the slice. The
    spans and counts leave out the traced slice (the profiler slows the host
    inside it)."""
    sp = w.spans.seconds
    window_s = w.t_end - w.t0 - (w.slice.window_s if w.slice is not None else 0.0)
    return SimpleNamespace(
        system=cell.system, window_s=window_s, frames=w.frames_spanned,
        supersteps=w.frames_spanned // w.period, period=w.period, streams=w.streams,
        add_image_s=sp.get("add_image", 0.0), run_chunk_s=sp.get("run_chunk", 0.0),
        joint_s=sp.get("joint", 0.0), chunk_fn_s=sp.get("chunk_fn", 0.0), capture_s=w.capture_s,
        slice=w.slice, launches=w.launches,
    )
