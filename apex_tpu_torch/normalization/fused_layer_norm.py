"""LayerNorm for the port: ``fused_layer_norm_affine``.

Counterpart of ``apex_tpu/normalization/fused_layer_norm.py``. The JAX
serving path never selects the Pallas LayerNorm kernel there
(``prefer_pallas`` is False), so its LayerNorm is XLA's, and this is plain
PyTorch: fp32 mean and variance, output in the input's dtype. The Hopper
LayerNorm kernels come with a later slice.
"""

from __future__ import annotations

import numbers

import torch

__all__ = ["fused_layer_norm_affine"]


def fused_layer_norm_affine(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, normalized_shape,
                            eps: float = 1e-5) -> torch.Tensor:
    """Affine LayerNorm over the trailing ``normalized_shape`` dims with
    fp32 statistics; the output takes ``x.dtype``."""
    shape = ((int(normalized_shape),)
             if isinstance(normalized_shape, numbers.Integral)
             else tuple(int(d) for d in normalized_shape))
    if tuple(x.shape[-len(shape):]) != shape:
        raise ValueError(f"normalized_shape {shape} does not match input "
                         f"tail {tuple(x.shape)}")
    dims = tuple(range(-len(shape), 0))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=dims, keepdim=True)
    out = c * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(x.dtype)
