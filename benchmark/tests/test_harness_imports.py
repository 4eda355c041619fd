"""Nothing the benchmark runs loads JAX or the JAX package: the check by
whole top-level names, a process that imports the harness, the reference
and the port's entry points, and the harness's sources."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness import spec

sys.path.insert(0, spec.BENCH_DIR)
import run  # noqa: E402


@pytest.mark.parametrize("mods,bad", [
    ({"sdvo_tpu_torch", "sdvo_tpu_torch.ops.build", "torch"}, []),
    ({"sdvo_tpu", "sdvo_tpu.config"}, ["sdvo_tpu", "sdvo_tpu.config"]),
    ({"jaxlib.xla_client", "flax", "jax_extra"}, ["flax", "jaxlib.xla_client"]),
    ({"sdvo_tpu_torchx", "jaxon"}, []),
])
def test_top_level_names_compared_whole(mods, bad):
    assert run.forbidden_modules(mods) == bad


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.harness.check, benchmark.harness.drive, "
            "benchmark.reference.pipeline.device_system, sdvo_tpu_torch.pipeline.device_system, "
            "sdvo_tpu_torch.parallel.multi_seq; sys.path.insert(0, %r); import run, control; "
            "print(run.forbidden_modules())" % (spec.ROOT, spec.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_bench_tool_and_the_reference_nothing_of_the_port():
    for base, _, files in os.walk(spec.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            for mod in _imports(path):
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "sdvo_tpu", "bench_torch", "chip_smoke", "tools"), path
                if os.sep + "reference" + os.sep in path:
                    assert top != "sdvo_tpu_torch", path


def test_no_card_means_no_result():
    out = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "run.py"), "--workload", "kitti_mono.live",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.returncode == 3 and out.stdout == ""
