"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root, each configuration's file (``configs/<name>.json``), each cell's
traffic (``workloads/<cell>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``, a function ``read(run)``). A cell, a configuration
or a metric is added by adding its file and its entry; nothing here names
one."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
DEFAULT_REFERENCE = "benchmark.reference"  # a configuration's reference where its file names none


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` (an entry of ``end_to_end`` or ``per_layer``) is
    reported in ``cell``: its ``workloads`` list, or every cell without one."""
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with its configuration's file and its
    traffic file: ``name``, ``entry``, ``config`` (the configuration file's
    object), ``traffic`` (the cell file's object), ``end_to_end`` and
    ``per_layer`` (the metrics reported in it).

    Of a configuration's file the harness reads ``system`` and ``n_seq``
    (the system driven, ``harness/drive.py``), ``camera`` and ``scene``
    (``benchmark/scene``), ``settings`` (the port's and the reference's
    ``Config``) and ``reference`` (the reference package's dotted name,
    ``DEFAULT_REFERENCE`` where it is absent). A configuration whose
    ``settings.camera`` size is not its ``camera``'s is refused."""

    def __init__(self, bench: dict, name: str, bench_dir: str = BENCH_DIR):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(entries)})")
        self.name = name
        self.entry = entries[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(os.path.dirname(bench_dir), self.config_entry["file"]))
        cam, size = self.config["camera"], self.config["settings"]["camera"]
        if (size["img_width"], size["img_height"]) != (cam["width"], cam["height"]):
            raise ValueError(f"configuration {self.config_entry['name']!r}: settings.camera is "
                             f"{size['img_width']}x{size['img_height']}, its camera {cam['width']}x{cam['height']}")
        self.traffic = load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]
        self.chips = int(self.entry["chips"])

    @property
    def system(self) -> str:
        return self.config["system"]

    @property
    def reference(self) -> str:
        return self.config.get("reference", DEFAULT_REFERENCE)


def reader(metric: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run, bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    """Each metric's value from its reader, with its unit; a reader that finds
    nothing to read (None) leaves its metric out."""
    out = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
