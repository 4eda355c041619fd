#!/usr/bin/env python3
"""The aten ops one ``DeviceSystem`` chunk dispatches a frame, on the CPU: a
proxy, before any chip run, for how a change to the eager glue moves the
card's launches a frame.

Run from the repository root: ``JAX_PLATFORMS=cpu python3
tools/count_chunk_ops.py [--tree DIR]``. On the 320×240 ridge scene of the
tests (``tests/test_pipeline_e2e.make_sequence``, seed 0, the overrides of
``tests/test_torch_device_system``; ``ba_iterations`` 2 as ``DeviceSystem``'s
default) it bootstraps, runs one chunk of two supersteps, and counts the
ops of the next chunk with a ``TorchDispatchMode``: those that are not
views and are not called from ``sdvo_tpu_torch/ops/`` (on the CPU the four
kernels run their plain versions, which on the card are one launch each).
Prints the count a frame, the part called from ``geometry/se3.py``, and the
``index_add`` / ``index_put`` / ``scatter`` ops a frame (those that the
deterministic mode replaces on the card). ``--tree DIR`` counts another
checkout's package, for a comparison of two trees. Imports JAX only for the
test scene's module.
"""

import argparse
import collections
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="the checkout whose package runs (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    sys.path.insert(1, os.path.join(ROOT, "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from sdvo_tpu_torch.config import load_config
    from sdvo_tpu_torch.geometry.camera import PinholeCamera
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem
    from test_pipeline_e2e import CAM, make_sequence
    from test_torch_device_system import OVERRIDES

    torch.set_num_threads(2)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.se3, self.indexed = 0, 0, collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            stack = traceback.extract_stack(limit=40)
            if not func.is_view and not any("/sdvo_tpu_torch/ops/" in f.filename for f in stack):
                self.ops += 1
                self.se3 += any(f.filename.endswith("geometry/se3.py") for f in stack)
                if any(k in str(func) for k in ("index_add", "index_put", "scatter")):
                    self.indexed[str(func)] += 1
            return func(*args, **(kwargs or {}))

    chunk = 6  # two supersteps of keyframe_every_n = 3
    _, images, _ = make_sequence(np.random.default_rng(0), n_frames=2 + 2 * chunk)
    ds = DeviceSystem(load_config(overrides=OVERRIDES), camera=PinholeCamera.create(**CAM), device="cpu",
                      supersteps_per_chunk=2, max_promote=32, ba_points=256, ba_iterations=2)
    for i in range(2 + chunk):
        ds.add_image(np.asarray(images[i], np.float64), float(i))
    with Count() as c:
        for i in range(2 + chunk, 2 + 2 * chunk):
            ds.add_image(np.asarray(images[i], np.float64), float(i))
    print(f"{os.path.abspath(args.tree)}: {c.ops / chunk:.1f} ops a frame (not views, outside the "
          f"kernels' plain versions), {c.se3 / chunk:.1f} of them from se3; indexed accumulations a "
          f"frame: {', '.join(f'{k} {v / chunk:.2f}' for k, v in sorted(c.indexed.items()))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
