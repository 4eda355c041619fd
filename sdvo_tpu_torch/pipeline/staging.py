"""Frames from the host to a device through one reused host buffer.

A chunk's frames are written in place into a host buffer laid out as the
chunk reads them (``FrameStaging.buffer``), copied to the device in one
piece and converted there to the float32 tensor the chunk takes
(``FrameStaging.to_device``). The buffer keeps 8-bit frames, which is what a
camera hands over, as 8-bit (uint8 → float32 is exact), so a quarter of the
bytes cross to the device; frames of any other type are staged as float32,
and ``np.copyto`` rounds them as ``astype(np.float32)`` does.

On a CUDA device the host buffer is pinned, and the copy is an asynchronous
one into a device buffer of the same type. A CUDA event after the copy lets
the next ``buffer`` call wait for it to end before the buffer is filled
again. Both buffers are allocated at the first chunk and again only when the
shape or the element type changes. Elsewhere the host buffer is a plain
tensor, converted where it lies. Either way the float32 tensor is a new one
each chunk: nothing the chunk keeps aliases a buffer that the next chunk
overwrites.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch


def staged_dtype(frames: Iterable[np.ndarray]) -> torch.dtype:
    """uint8 where every frame is 8-bit, float32 otherwise."""
    return torch.uint8 if all(f.dtype == np.uint8 for f in frames) else torch.float32


class FrameStaging:
    """The staging buffers of frames bound for ``device`` (see the module's
    docstring). ``host`` is the host buffer (None before the first chunk)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.host: Optional[torch.Tensor] = None
        self._card: Optional[torch.Tensor] = None
        self._copied = None  # torch.cuda.Event recorded after the last copy out of ``host``

    def buffer(self, shape: Sequence[int], dtype: torch.dtype) -> np.ndarray:
        """The host buffer as a numpy array of ``shape`` and ``dtype``, to be
        filled in place: the last call's where both match, else a new one,
        once the last copy out of it has ended."""
        if self._copied is not None:
            self._copied.synchronize()
        shape = tuple(shape)
        if self.host is None or tuple(self.host.shape) != shape or self.host.dtype != dtype:
            self.host = torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")
            self._card = None
        return self.host.numpy()

    def to_device(self) -> torch.Tensor:
        """The host buffer on the device as a new float32 tensor: on a CUDA
        device one asynchronous copy into the device buffer and the
        conversion there; elsewhere the conversion of the host buffer."""
        if self.device.type != "cuda":
            return self.host.to(torch.float32, copy=True)
        if self._card is None:
            self._card = torch.empty(self.host.shape, dtype=self.host.dtype, device=self.device)
            self._copied = torch.cuda.Event()
        self._card.copy_(self.host, non_blocking=True)
        self._copied.record(torch.cuda.current_stream(self.device))
        return self._card.to(torch.float32, copy=True)
