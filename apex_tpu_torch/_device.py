"""Device resolution shared by the port's public entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card present
    raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA card is available; pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    return dev
