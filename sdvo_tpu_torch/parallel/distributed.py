"""The multi-process runtime — port of ``sdvo_tpu.parallel.distributed``.

Every process runs the same program; ``initialize_from_env`` forms the
``torch.distributed`` process group from the same environment contract as
the JAX package's ``jax.distributed.initialize`` wiring:

    SDVO_COORDINATOR   "host:port" of process 0   (init_method "tcp://host:port")
    SDVO_NUM_PROCESSES total process count        (world_size)
    SDVO_PROCESS_ID    this process's index       (rank)

``SDVO_AUTO_DISTRIBUTED=1`` (with none of the three set) reads torchrun's
variables instead (``init_method="env://"``): the counterpart of the TPU pod
auto-detection. Without any of them the call is a no-op and the program runs
as one process.

The backend is NCCL when the process's device is a card (the default:
``device.resolve_device``) and gloo only when the caller asks for the CPU.
A group that cannot be formed raises; nothing falls back to gloo or to one
process. Once the group exists, ``parallel.dist_ba`` and
``parallel.pose_graph`` reduce over it: each rank holds its own shards.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from sdvo_tpu_torch.device import resolve_device


def initialize_from_env(force: bool = False, device=None) -> bool:
    """Form the process group if the environment asks for it.

    Returns True when the group was formed (or already was), False for the
    single-process case. ``device`` is this process's device: the CUDA card
    by default (NCCL; a card without an index means the current one), and
    ``"cpu"`` for gloo. ``force`` forms the group again."""
    if dist.is_initialized():
        if not force:
            return True
        dist.destroy_process_group()
    coord = os.environ.get("SDVO_COORDINATOR")
    nproc = os.environ.get("SDVO_NUM_PROCESSES")
    pid = os.environ.get("SDVO_PROCESS_ID")
    if coord is None and nproc is None:
        if os.environ.get("SDVO_AUTO_DISTRIBUTED", "0") != "1":
            return False
        init = dict(init_method="env://")
    else:
        if coord is None or nproc is None or pid is None:
            raise RuntimeError("SDVO_COORDINATOR, SDVO_NUM_PROCESSES and SDVO_PROCESS_ID are set "
                               "together or not at all")
        init = dict(init_method=f"tcp://{coord}", world_size=int(nproc), rank=int(pid))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(backend=backend, **init)
    return True


def runtime_info() -> dict:
    """Process/device topology for logs: the JAX package's five keys.
    ``platform`` is ``"gpu"`` for an NCCL group or, without a group, where a
    card is present; ``"cpu"`` otherwise. ``global_devices`` counts this
    process's devices once per process of the group."""
    if dist.is_initialized():
        gpu = dist.get_backend() == "nccl"
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        gpu = torch.cuda.is_available()
        index, count = 0, 1
    local = torch.cuda.device_count() if gpu else 1
    return {
        "process_index": index,
        "process_count": count,
        "local_devices": local,
        "global_devices": local * count,
        "platform": "gpu" if gpu else "cpu",
    }


def shard_sum(parts) -> torch.Tensor:
    """The sum of the shards' partials (a list, one a shard, in shard order):
    ``psum`` over the ``shard`` axis. The local shards are added in order
    0…S−1 on shard 0's device, so the bits do not depend on the run; in a
    process group the result is then summed over the ranks by one
    ``all_reduce``, each rank holding its own shards. The first part may be
    overwritten."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    if dist.is_initialized():
        dist.all_reduce(total)
    return total
