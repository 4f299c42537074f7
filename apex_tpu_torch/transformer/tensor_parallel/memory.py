"""Reusable memory buffers.

Counterpart of ``apex_tpu/transformer/tensor_parallel/memory.py``.
Reference: ``reference:apex/transformer/tensor_parallel/memory.py:35-146``:
:class:`MemoryBuffer` hands out views of one preallocated flat tensor
(for checkpointed activations), :class:`RingMemBuffer` rotates over
``num_buffers`` of them. In torch they do what the reference does: the
flat tensor is allocated once on ``device`` (the card unless the caller
asks for the CPU), :meth:`MemoryBuffer.add` returns the next ``numel``
elements as a view of the requested shape, zero-filled (the JAX
package's ``add`` returns zeros), and a request past the end raises
``RuntimeError``. ``track_usage`` is taken and, as in the JAX package,
counts nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch._device import resolve_device

__all__ = ["MemoryBuffer", "RingMemBuffer", "allocate_mem_buff"]


class MemoryBuffer:
    def __init__(self, name: str, numel: int, dtype,
                 track_usage: bool = False, device="cuda"):
        self.name = name
        self.numel = numel
        self.dtype = dtype
        self.data = torch.empty(numel, dtype=dtype,
                                device=resolve_device(device))
        self._start = 0
        self.in_use_value = 0
        self.total_value = 0

    def reset(self) -> None:
        """Hand the whole buffer out again from its start."""
        self._start = 0

    def is_in_use(self) -> bool:
        return self._start > 0

    def numel_in_use(self) -> int:
        return self._start

    def add(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """The next ``prod(shape)`` elements as a zeroed view of
        ``shape``."""
        numel = 1
        for d in shape:
            numel *= int(d)
        if self._start + numel > self.numel:
            raise RuntimeError(f"memory buffer {self.name} overflow")
        view = self.data[self._start:self._start + numel].view(*shape)
        view.zero_()
        self._start += numel
        return view

    def get_data(self) -> torch.Tensor:
        """The whole flat buffer (the views alias it)."""
        return self.data


class RingMemBuffer:
    def __init__(self, name: str, num_buffers: int, numel: int, dtype,
                 track_usage: bool = False, device="cuda"):
        self.num_buffers = num_buffers
        self.buffers = [MemoryBuffer(f"{name} {i}", numel, dtype,
                                     track_usage, device)
                        for i in range(num_buffers)]
        self._index = -1

    def get_next_buffer(self) -> MemoryBuffer:
        """The next buffer of the ring, reset."""
        self._index = (self._index + 1) % self.num_buffers
        buf = self.buffers[self._index]
        buf.reset()
        return buf


def allocate_mem_buff(name: str, numel: int, dtype,
                      track_usage: bool = False, device="cuda"
                      ) -> MemoryBuffer:
    return MemoryBuffer(name, numel, dtype, track_usage, device)
