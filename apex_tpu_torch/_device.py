"""Device resolution and kernel selection shared by the port's public
entry points."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["resolve_device", "use_kernel_for"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card present
    raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA card is available; pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    return dev


def use_kernel_for(use_kernel: Optional[bool], x: torch.Tensor) -> bool:
    """The port's ``use_kernel`` contract (the reference's ``use_pallas``):
    ``None`` picks the CUDA kernels iff ``x`` lies on a CUDA device,
    ``True`` on a CPU tensor raises, ``False`` picks the plain version."""
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError(
            "use_kernel=True needs CUDA tensors: the kernels run only on "
            f"the card, got a tensor on {x.device}")
    return bool(use_kernel)
