#!/usr/bin/env python3
"""The first op of the multi-sequence superstep whose result depends on a
sequence's slot in the batch, or on the run.

Run from the repository root: ``python3 tools/trace_isolation.py [--device
cuda|cpu] [--seeds 0,4] [--supersteps 2] [--chunks 1] [--out FILE]``. Renders two
textures A and B of bench.py's scene, bootstraps them once through
``MultiSequenceSystem`` (S = 2, on the card by default) and runs the joint
chunks of the vmapped superstep, in the mode the joint phase ships with, on
their states stacked three times: [A, B], [B, A] and [A, B] again
(``chip_smoke.joint_by_slot``). During the
joint chunks a ``TorchDispatchMode`` records every op the vmapped superstep
dispatches, with the digest of each input and output tensor as it is and
with the halves of each axis of even length swapped (the batch axis is one
of them, or the axis a batching rule folds it into). An op agrees between
two runs where each of its outputs in the second run has the digest of the
first run's output or of one of those swaps (or, for a loop over the
members, of an op of the same name and caller a few ops away): [B, A]
against [A, B] asks whether any op rounds a member by its slot, [A, B]
against itself whether any op changes its bits from run to
run. For each comparison the tool prints the number of ops recorded, the
number that disagree, and the first that does: its name, the source line in
``sdvo_tpu_torch`` that called it, its input and output shapes, and whether
its inputs agreed (then the op itself is the one that differs); ``--out``
writes the whole report as JSON. Imports nothing of JAX.
"""

import argparse
import hashlib
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

PKG = os.path.join(ROOT, "sdvo_tpu_torch") + os.sep
SKIP = ("empty", "resize", "set_.")  # ops whose outputs hold memory nobody wrote yet


def _digest(t: torch.Tensor) -> str:
    return hashlib.blake2b(t.contiguous().cpu().numpy().tobytes(), digest_size=12).hexdigest()


def _variants(t: torch.Tensor) -> dict:
    """Digest of ``t`` as it is ("as is") and with the halves of each axis of
    even length swapped (the batch axis of S = 2, or an axis a batching rule
    folded it into); with its shape and type."""
    t = t.detach()
    out = {"as is": _digest(t)}
    for d, n in enumerate(t.shape):
        if n % 2 == 0 and n > 0:
            out[d] = _digest(t.roll(n // 2, d))
    return {"digests": out, "shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", "")}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _caller() -> str:
    """The innermost frame of the port's package on the stack, as file:line."""
    for fr in reversed(traceback.extract_stack()):
        if fr.filename.startswith(PKG):
            return f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno}"
    return "?"


class OpRecord(TorchDispatchMode):
    """Records (op, caller, input variants, output variants) of every op."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if not any(s in name for s in SKIP):
            ins = [_variants(t) for t in _tensors((args, kwargs or {}))]
            self.ops.append({"op": name, "at": _caller(), "in": ins,
                             "out": [_variants(t) for t in _tensors(out)]})
        return out


def _agree(a: dict, b: dict) -> bool:
    return b["digests"]["as is"] in a["digests"].values()


NEAR = 16  # ops a batching rule's loop over the members may reorder (the CPU's)


def _matches(first, i: int, op: dict) -> bool:
    """Whether ``op``, the i-th op of the second run, agrees with the i-th
    of the first, or with an op of the same name and caller near it (a loop
    over the batch's members takes them in the order of their slots)."""
    for j in range(max(0, i - NEAR), min(len(first), i + NEAR + 1)):
        f = first[j]
        if (j == i or (f["op"], f["at"]) == (op["op"], op["at"])) and len(f["out"]) == len(op["out"]) \
                and all(_agree(a, b) for a, b in zip(f["out"], op["out"])):
            return True
    return False


def compare(first, second, label: str) -> dict:
    """The ops of ``second`` against those of ``first``, in order."""
    n = min(len(first), len(second))
    bad = [i for i in range(n) if not _matches(first, i, second[i])]
    report = {"comparison": label, "ops": [len(first), len(second)], "disagree": len(bad),
              "same_sequence": all(first[i]["op"] == second[i]["op"] for i in range(n))}
    if bad:
        i = bad[0]
        op = second[i]
        report["first"] = {
            "index": i, "op": op["op"], "at": op["at"],
            "inputs_agree": all(_agree(a, b) for a, b in zip(first[i]["in"], op["in"])),
            "inputs": [(x["shape"], x["dtype"]) for x in op["in"]],
            "outputs": [(x["shape"], x["dtype"]) for x in op["out"]],
        }
        report["next"] = [(second[j]["op"], second[j]["at"]) for j in bad[1:10]]
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--seeds", default="0,4")
    ap.add_argument("--supersteps", type=int, default=2, help="supersteps a joint chunk")
    ap.add_argument("--chunks", type=int, default=1, help="joint chunks recorded")
    ap.add_argument("--out", default=None, help="a JSON file for the whole report")
    args = ap.parse_args()

    import chip_smoke
    from sdvo_tpu_torch.dataio.synthetic import render_bench_sequences
    from sdvo_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    n_frames = 2 + chip_smoke.PER * args.supersteps * args.chunks
    pair = [r[0] for r in render_bench_sequences(seeds, n_frames)]
    labels = ("AB", "BA", "AB again")
    recs = [OpRecord() for _ in labels]
    t0 = time.perf_counter()
    by_order = chip_smoke.joint_by_slot(pair, args.supersteps, args.chunks, orders=((0, 1), (1, 0), (0, 1)),
                                        around=lambda k: recs[k], device=device)
    records = dict(zip(labels, (r.ops for r in recs)))
    print(f"runs {', '.join(f'{k}: {len(v)} ops' for k, v in records.items())} recorded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reports = [compare(records["AB"], records["BA"], "slot: [B, A] against [A, B]"),
               compare(records["AB"], records["AB again"], "run: [A, B] against [A, B]")]
    a_slot = chip_smoke.same_bits(by_order[0][0], by_order[1][0])
    a_run = chip_smoke.same_bits(by_order[0][0], by_order[2][0])
    summary = {"device": str(device), "seeds": seeds, "frames": n_frames,
               "A_same_bits_in_slot_1": a_slot, "A_same_bits_run_to_run": a_run, "reports": reports}
    for r in reports:
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "reports"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
