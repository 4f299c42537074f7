"""Inverted dropout for the port.

Counterpart of ``apex_tpu/ops/dropout.py``: scaled by ``1 / (1 - rate)`` at
train time, the identity at rate 0 or without a generator (eval mode). The
reference draws its mask from a ``jax.random`` key; here an explicit
``torch.Generator`` takes the key's place. The two generators give
different bits from one seed, so the port holds to the reference's
semantics (keep probability, scaling, identity cases), not its bits.
Attention-probability dropout is not here: it runs inside the flash kernels
(:func:`apex_tpu_torch.ops.flash_attention.flash_attention`).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dropout"]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout of ``x`` keyed by ``generator``; the identity when
    ``rate == 0`` or ``generator is None``. The mask is drawn where ``x``
    lies, so ``generator`` must be on ``x``'s device."""
    if rate == 0.0 or generator is None:
        return x
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if _index(generator.device) != _index(x.device):
        raise ValueError(f"dropout generator on {generator.device}, input "
                         f"on {x.device}: they must share a device")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _index(device: torch.device) -> torch.device:
    """``device`` with its index made explicit, so ``cuda`` equals
    ``cuda:0`` on a one-card machine."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
