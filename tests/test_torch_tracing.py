"""The port's tracer (``sdvo_tpu_torch.utils.timing``) alone: off it records
nothing and reads no clock; on, spans nest with their parent and dispatch
number, counters add up, ``Timers`` reads its own spans back, a span under
``torch.profiler`` is a ``sdvo/`` range, and ``cuda_graph.stage_map`` puts
each device operation launched inside the run of a synthetic trace under
the innermost range open at its launch. The spans of the systems
themselves are held in ``test_torch_device_system.py`` and
``test_torch_multi_seq.py``."""

import time
from types import SimpleNamespace

import torch

from sdvo_tpu_torch.pipeline.cuda_graph import RUN, stage_map
from sdvo_tpu_torch.utils.timing import PREFIX, TRACER, Timers, Tracer


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    t = Tracer()

    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(time, "perf_counter", no_clock)
    assert t.span("a") is t.span("b", ends_dispatch=True)  # one shared context
    with t.span("a"):
        t.count("n", 1)
    t.sync(torch.device("cpu"))
    assert (t.spans, t.counts, t.dispatches) == ([], [], 0)
    assert not TRACER.on  # the process's tracer is off by default


def test_spans_nest_with_parent_and_dispatch():
    t = Tracer()
    with t.recording():
        with t.span("buffer"):
            pass
        with t.span("dispatch", ends_dispatch=True):
            with t.span("stack"):
                t.count("frames", 3)
            with t.span("emit"):
                with t.span("inner"):
                    t.count("frames", 2)
        with t.span("buffer"):
            pass
    assert not t.on
    got = [(s.name, s.parent, s.dispatch, s.profiled) for s in t.closed()]
    assert got == [("buffer", -1, 0, False), ("dispatch", -1, 0, False), ("stack", 1, 0, False),
                   ("emit", 1, 0, False), ("inner", 3, 0, False), ("buffer", -1, 1, False)]
    assert t.dispatches == 1 and t.counter("frames") == 5
    assert all(s.start <= s.end for s in t.closed())
    outer, inner = t.spans[1], t.spans[4]
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert t.summary()["buffer"]["count"] == 2 and t.summary()["buffer"]["total_s"] >= 0
    with t.recording(False):
        assert not t.on and t.dispatches == 1  # off keeps what was recorded
    with t.recording():
        with t.recording():  # a block inside another adds to its record
            t.count("frames", 1)
        assert t.on and t.counter("frames") == 1 and t.dispatches == 0


def test_timers_read_their_own_spans():
    t = Tracer()
    timers = Timers("system.", tracer=t)
    with timers.scope("pyramid"):
        pass
    assert timers.summary() == {}  # off
    with t.recording():
        for _ in range(3):
            with timers.scope("pyramid"):
                pass
        with t.span("device_system.stack"):
            pass
    assert set(timers.summary()) == {"pyramid"} and timers.summary()["pyramid"]["count"] == 3
    assert timers.report().splitlines()[1].startswith("pyramid ")
    assert set(t.summary()) == {"system.pyramid", "device_system.stack"}


def test_a_span_under_the_profiler_is_a_program_range():
    from torch.profiler import ProfilerActivity, profile

    t = Tracer()
    with t.recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with t.span("graph.replay"):
                torch.ones(4).sum()
        with t.span("graph.replay"):
            pass
    names = [e.name for e in prof.events()]
    assert PREFIX + "graph.replay" in names
    assert [s.profiled for s in t.closed()] == [True, False]


class _Event(SimpleNamespace):
    def name(self):
        return self.n

    def device_type(self):
        return self.d

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.link


def test_stage_map_puts_each_operation_under_its_innermost_range():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [
        # the pre-roll before the run: its operations are left out, and one it lost does not count
        _Event(n="cudaLaunchKernel", d=cpu, a=2, b=3, c=40, link=0),
        _Event(n="cudaLaunchKernel", d=cpu, a=3, b=4, c=41, link=0),
        _Event(n="k_preroll", d=cuda, a=999, b=1000, c=40, link=0),
        _Event(n=RUN, d=cpu, a=5, b=160, c=6, link=0),
        _Event(n=RUN, d=cuda, a=999, b=1006, c=6, link=0),
        _Event(n=PREFIX + "device_vo.align", d=cpu, a=0, b=100, c=1, link=0),
        _Event(n="aten::mul", d=cpu, a=10, b=20, c=2, link=0),
        _Event(n="cudaLaunchKernel", d=cpu, a=12, b=14, c=50, link=2),
        _Event(n=PREFIX + "device_vo.kf.ba", d=cpu, a=30, b=60, c=3, link=0),
        _Event(n="cudaMemcpyAsync", d=cpu, a=40, b=41, c=51, link=0),
        _Event(n="aten::add", d=cpu, a=70, b=80, c=4, link=0),  # its kernel has no runtime call
        _Event(n="cudaLaunchKernel", d=cpu, a=150, b=151, c=52, link=0),  # outside every range
        # the device's operations, out of order; the range's own mirror is no operation
        _Event(n="k_add", d=cuda, a=1003, b=1004, c=99, link=4),
        _Event(n="k_mul", d=cuda, a=1000, b=1001, c=50, link=2),
        _Event(n="Memcpy DtoD (Device -> Device)", d=cuda, a=1002, b=1003, c=51, link=0),
        _Event(n="k_late", d=cuda, a=1005, b=1006, c=52, link=0),
        _Event(n=PREFIX + "device_vo.align", d=cuda, a=1000, b=1004, c=1, link=0),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: ev)))
    assert stage_map(prof) == (("k_mul", "device_vo.align"), ("Memcpy DtoD (Device -> Device)", "device_vo.kf.ba"),
                               ("k_add", "device_vo.align"), ("k_late", ""))
    lost = [e for e in ev if e.n != "k_late"]  # a launch whose operation the trace does not hold
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: lost)))
    assert stage_map(prof) is None
