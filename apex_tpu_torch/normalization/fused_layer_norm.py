"""LayerNorm for the port: ``fused_layer_norm_affine``.

Counterpart of ``apex_tpu/normalization/fused_layer_norm.py``. The JAX path
never selects the Pallas LayerNorm kernels there (``prefer_pallas`` is
False), so its LayerNorm is XLA's, and this is plain PyTorch: fp32 mean and
variance, output in the input's dtype, and an ``autograd.Function`` whose
backward is the reference's closed form (``_make_core``'s XLA backward),
from the saved ``(x, mean, invvar)`` rather than through autograd of the
forward's ops. It is the plain twin of the Hopper LayerNorm kernels of a
later slice.
"""

from __future__ import annotations

import numbers

import torch

__all__ = ["fused_layer_norm_affine"]


class _LayerNormAffine(torch.autograd.Function):
    """Affine LayerNorm over the last dim of a 2-D ``x``."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps: float):
        xf = x2d.float()
        mean = xf.mean(dim=-1, keepdim=True)
        c = xf - mean
        var = (c * c).mean(dim=-1, keepdim=True)
        invvar = torch.rsqrt(var + eps)
        out = c * invvar * weight.float() + bias.float()
        ctx.save_for_backward(x2d, mean, invvar, weight)
        ctx.bias_dtype = bias.dtype
        return out.to(x2d.dtype)

    @staticmethod
    def backward(ctx, dy):
        x2d, mean, invvar, weight = ctx.saved_tensors
        dyf = dy.float()
        xhat = (x2d.float() - mean) * invvar
        dxhat = dyf * weight.float()
        m1 = dxhat.mean(dim=-1, keepdim=True)
        m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
        dx = invvar * (dxhat - m1 - xhat * m2)
        dw = (dyf * xhat).sum(dim=0).to(weight.dtype)
        db = dyf.sum(dim=0).to(ctx.bias_dtype)
        return dx.to(x2d.dtype), dw, db, None


def fused_layer_norm_affine(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, normalized_shape,
                            eps: float = 1e-5) -> torch.Tensor:
    """Affine LayerNorm over the trailing ``normalized_shape`` dims with
    fp32 statistics; the output takes ``x.dtype``, the weight and bias
    grads their own dtypes."""
    shape = ((int(normalized_shape),)
             if isinstance(normalized_shape, numbers.Integral)
             else tuple(int(d) for d in normalized_shape))
    if tuple(x.shape[-len(shape):]) != shape:
        raise ValueError(f"normalized_shape {shape} does not match input "
                         f"tail {tuple(x.shape)}")
    h = 1
    for d in shape:
        h *= d
    out = _LayerNormAffine.apply(x.reshape(-1, h), weight.reshape(h),
                                 bias.reshape(h), float(eps))
    return out.reshape(x.shape)
