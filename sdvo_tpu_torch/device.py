"""Where the port's entry points run: on the CUDA card unless the caller asks
for another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card. Raises
    where there is none: the port never moves to the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port runs on the card by default; pass '
                           'device="cpu" to run on the CPU')
    return torch.device("cuda")
