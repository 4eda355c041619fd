"""Per-module leveled logging — a copy of ``sdvo_tpu.utils.logging``,
mirroring the reference's easylogging++ setup.

The reference defines 11 per-module loggers (Main, System, Depth, Optimizer,
Algorithm, Feature, Map, Alignment, Adjustment, Config, Visualization — e.g.
``#define System_Log(LEVEL) CLOG(LEVEL, "System")``, src/system.cpp:13) with
per-module enable/file/stdout switches in config/log.conf. Here each maps to a
child of the ``sdvo`` logging hierarchy with the same names; ``configure_logging``
accepts a dict in the spirit of log.conf sections.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, Optional

MODULES = (
    "Main", "System", "Depth", "Optimizer", "Algorithm", "Feature",
    "Map", "Alignment", "Adjustment", "Config", "Visualization",
)

_CONFIGURED = False


def get_logger(module: str = "Main") -> logging.Logger:
    return logging.getLogger(f"sdvo.{module}")


def configure_logging(
    level: int = logging.INFO,
    per_module: Optional[Dict[str, int]] = None,
    log_file: Optional[str] = None,
    stream=None,
):
    """Set up the sdvo logger hierarchy (config/log.conf analog)."""
    global _CONFIGURED
    root = logging.getLogger("sdvo")
    root.setLevel(logging.DEBUG)
    root.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname).1s [%(name)s] %(message)s", "%H:%M:%S")
    h = logging.StreamHandler(stream or sys.stderr)
    h.setLevel(level)
    h.setFormatter(fmt)
    root.addHandler(h)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    for m in MODULES:
        lg = get_logger(m)
        lg.setLevel((per_module or {}).get(m, logging.NOTSET))
    _CONFIGURED = True


def write_metrics_jsonl(path: str, records):
    """Per-frame metrics dump (SURVEY §5 observability plan)."""
    import json

    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
