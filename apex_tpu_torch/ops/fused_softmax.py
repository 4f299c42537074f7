"""Fused scale + mask + softmax for the port.

Counterpart of ``apex_tpu/ops/fused_softmax.py`` (Megatron's
``ScaledUpperTriangMaskedSoftmax``, ``ScaledMaskedSoftmax`` and the
``FusedScaleMaskSoftmax`` dispatcher). The reference has no Pallas kernel
here (XLA fuses the chain; the flash kernels are where the softmax fusion
saves memory), so the port computes it with ``torch`` ops: the scores in
fp32, scaled, masked by a ``-10000`` fill (so a fully masked row comes out
uniform, not zero and not NaN), softmax, returned in the input dtype. A
``True`` in a mask marks a position to *drop* (Megatron's convention).
The dispatcher keeps the reference's eligibility rule
(``is_kernel_available``, ``get_batch_per_block``: whether apex's CUDA
kernel would have run) and its ``mask_func`` fallback branch.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch
from torch import nn

__all__ = [
    "AttnMaskType", "scaled_upper_triang_masked_softmax",
    "scaled_masked_softmax", "FusedScaleMaskSoftmax",
]

_MASK_FILL = -10000.0


class AttnMaskType(enum.Enum):
    """Megatron's attention mask types (``transformer/enums.py``)."""
    padding = 1
    causal = 2


def scaled_upper_triang_masked_softmax(x: torch.Tensor,
                                       scale: float = 1.0) -> torch.Tensor:
    """Causal softmax over ``(..., sq, sk)``: column ``j`` of row ``i`` is
    dropped where ``j > i + (sk - sq)``. fp32 inside, ``x.dtype`` out."""
    sq, sk = x.shape[-2], x.shape[-1]
    xf = x.to(torch.float32) * scale
    row = torch.arange(sq, device=x.device)[:, None]
    col = torch.arange(sk, device=x.device)[None, :]
    xf = xf.masked_fill(col > row + (sk - sq), _MASK_FILL)
    return torch.softmax(xf, dim=-1).to(x.dtype)


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float = 1.0) -> torch.Tensor:
    """Softmax under a boolean ``mask`` broadcast over ``(b, np, sq, sk)``
    (``True`` drops). fp32 inside, ``x.dtype`` out."""
    xf = x.to(torch.float32) * scale
    if mask is not None:
        xf = xf.masked_fill(mask, _MASK_FILL)
    return torch.softmax(xf, dim=-1).to(x.dtype)


class FusedScaleMaskSoftmax(nn.Module):
    """Megatron's dispatcher over ``(b, np, sq, sk)`` scores: causal
    (``sq == sk``) or padding-masked softmax, or, with ``mask_func`` and
    ``scaled_masked_softmax_fusion=False``, the reference's fallback
    (``mask_func(scores * scale, mask)``, then the softmax, in fp32 where
    the input is half and ``softmax_in_fp32``)."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = False,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        super().__init__()
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError(
                "both fp16 and bf16 flags cannot be active at the same time.")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if not (scale is None or softmax_in_fp32):
            raise RuntimeError("softmax should be in fp32 when scaled")

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError("input must be (b, np, sq, sk)")
        scale = self.scale if self.scale is not None else 1.0
        if self.attn_mask_type == AttnMaskType.causal:
            b, np_, sq, sk = x.shape
            if sq != sk:
                raise ValueError("causal mask is only for self attention")
            out = scaled_upper_triang_masked_softmax(
                x.reshape(-1, sq, sk), scale)
            return out.reshape(b, np_, sq, sk)
        if self.mask_func is not None and \
                not self.scaled_masked_softmax_fusion:
            xf = (x.to(torch.float32)
                  if self.input_in_float16 and self.softmax_in_fp32 else x)
            xf = xf * scale
            xf = self.mask_func(xf, mask) if mask is not None else xf
            return torch.softmax(xf, dim=-1).to(x.dtype)
        return scaled_masked_softmax(x, mask, scale)

    def is_kernel_available(self, mask, b: int, np_: int, sq: int,
                            sk: int) -> bool:
        """Whether apex's CUDA kernel would have run at these sizes."""
        attn_batches = b * np_
        if not (self.scaled_masked_softmax_fusion and self.input_in_float16
                and mask is not None and 16 < sk <= 2048
                and sq % 4 == 0 and attn_batches % 4 == 0):
            return False
        batch_per_block = self.get_batch_per_block(sq, sk, b, np_)
        if self.attn_mask_type == AttnMaskType.causal:
            return attn_batches % batch_per_block == 0
        return sq % batch_per_block == 0

    @staticmethod
    def get_batch_per_block(sq: int, sk: int, b: int, np_: int) -> int:
        """apex's heuristic: 128-thread blocks over the next power of two
        of ``sk`` columns."""
        pow2 = 1 << max(sk - 1, 1).bit_length()
        warp_size = min(32, pow2)
        batches_per_warp = 2 if pow2 <= 128 else 1
        warps_per_block = 128 // warp_size
        return warps_per_block * batches_per_warp
