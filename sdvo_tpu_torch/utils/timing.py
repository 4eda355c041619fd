"""Scope timers — a copy of ``sdvo_tpu.utils.timing``. Accumulates wall time
per named stage. Device work is asynchronous: a scope holds a stage's device
time only where the stage ends in a host read (every stage of the per-frame
host ``System`` does) or the caller synchronises inside it."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class Timers:
    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.total[k],
                "count": self.count[k],
                "mean_ms": 1e3 * self.total[k] / max(self.count[k], 1),
            }
            for k in self.total
        }

    def report(self) -> str:
        lines = ["stage                   count   mean_ms   total_s"]
        for k, v in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{k:22s} {v['count']:6d} {v['mean_ms']:9.2f} {v['total_s']:9.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def scope_timer(name: str, logger=None):
    t0 = time.perf_counter()
    yield
    dt = (time.perf_counter() - t0) * 1e3
    if logger:
        logger.debug("%s: %.2f ms", name, dt)
