"""Where the port's entry points run: on the CUDA card unless the caller asks
for another device; and how they run there: with PyTorch's deterministic
algorithms (``deterministic_on``), so that a run gives the same bits every
time, as the reference's compiled scan does."""

from __future__ import annotations

import contextlib
import functools
import os

import torch

# cuBLAS is reproducible only with a fixed workspace, which it reads at the
# process's first cuBLAS call: the package sets it when it is imported (a
# value the caller set stays)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card. Raises
    where there is none: the port never moves to the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port runs on the card by default; pass '
                           'device="cpu" to run on the CPU')
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype)`` on ``device``, built once per
    (values, dtype, device) and shared by every later call: a tensor built
    from Python data on the card is a synchronous copy from the host, which
    a CUDA graph cannot hold. Callers only read it."""
    return torch.tensor(values, dtype=dtype).to(device)


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms inside the block, so that a run on
    the card gives the same bits every time: ``index_add`` of floats (the
    bundle adjustment's normal equations) then sums through a sort in a fixed
    order instead of by atomic adds in whatever order the threads reach
    them. An op without a deterministic form warns instead of raising. Memory
    from ``torch.empty`` stays unfilled, as outside. cuBLAS is reproducible
    only with ``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8``) set before the
    process's first cuBLAS call: importing the package sets it unless the
    caller has."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def deterministic_on(device: torch.device):
    """``deterministic_algorithms()`` where ``device`` is a CUDA card, nothing
    on the CPU (whose ops are deterministic already): the mode every entry
    point runs its device work in."""
    return deterministic_algorithms() if device.type == "cuda" else contextlib.nullcontext()
