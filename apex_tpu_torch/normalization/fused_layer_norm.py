"""Fused LayerNorm and RMSNorm for the port.

Counterpart of ``apex_tpu/normalization/fused_layer_norm.py``: the
functions ``fused_layer_norm_affine``, ``fused_layer_norm``,
``fused_rms_norm_affine``, ``fused_rms_norm`` and the mixed-dtype
``mixed_dtype_fused_layer_norm_affine``/``mixed_dtype_fused_rms_norm_affine``,
and the modules ``FusedLayerNorm``, ``FusedRMSNorm``, ``MixedFusedLayerNorm``
and ``MixedFusedRMSNorm`` (``nn.Module``s holding their weight and bias,
where the reference's are parameter factories).

Dtype rules as the reference's: statistics (mean, invvar) are fp32; the
standard functions output the input's dtype, the mixed ones the weight's.

One ``torch.autograd.Function`` (:class:`_FusedNorm`) runs either the
hand-written CUDA kernels ``ln_fwd``/``ln_bwd`` (``csrc/layer_norm.cu``,
replacing the reference's Pallas ``ln_fwd``/``ln_bwd``) or their plain
twins :func:`_ln_fwd_plain`/:func:`_ln_bwd_plain` beside it, copied from
the reference's XLA forward and backward (``_make_core``). The backward is
the closed form from the saved ``(x, mean, invvar)``, not autograd through
the forward's ops. ``use_kernel`` follows the port's contract: ``None``
runs the kernels iff the input lies on a CUDA device, ``True`` on a CPU
tensor raises, ``False`` runs the plain twins. The reference never picks
its Pallas kernels (``prefer_pallas``, a TPU measurement); that choice
does not carry over. On CUDA there is no shape-based fallback: a width the
kernels do not take (not a multiple of 8, or above 65536) raises.
"""

from __future__ import annotations

import numbers
from typing import Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch import _kernels
from apex_tpu_torch._device import resolve_device, use_kernel_for
from apex_tpu_torch.remat import region_op

__all__ = [
    "fused_layer_norm", "fused_layer_norm_affine",
    "fused_rms_norm", "fused_rms_norm_affine",
    "mixed_dtype_fused_layer_norm_affine", "mixed_dtype_fused_rms_norm_affine",
    "FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
    "MixedFusedRMSNorm",
]


def _norm_shape(normalized_shape) -> Tuple[int, ...]:
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(d) for d in normalized_shape)


# ---------------------------------------------------------------------------
# the plain twins of ln_fwd / ln_bwd
# ---------------------------------------------------------------------------

def _ln_fwd_plain(x2d: torch.Tensor, weight: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor], eps: float, rms: bool,
                  out_dtype: torch.dtype):
    """The function ``ln_fwd`` computes: ``(out (n, h) in out_dtype, mean
    (n, 1), invvar (n, 1))``, statistics in fp32, the mean first and then
    the mean of centred squares (RMSNorm: mean 0 and the mean of
    squares)."""
    xf = x2d.float()
    if rms:
        invvar = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        mean = torch.zeros_like(invvar)
        xhat = xf * invvar
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        c = xf - mean
        invvar = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
        xhat = c * invvar
    out = xhat
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype), mean, invvar


def _ln_bwd_plain(dy2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                  invvar: torch.Tensor, weight: Optional[torch.Tensor],
                  rms: bool, has_bias: bool):
    """The function ``ln_bwd`` computes: ``(dx in x's dtype, dweight,
    dbias)``, ``dx = invvar (dxhat - mean(dxhat) - xhat mean(dxhat xhat))``
    (RMSNorm without the first mean), ``dweight``/``dbias`` summed over the
    rows in fp32 and cast to the weight's dtype (fp32 without one), ``None``
    where not wanted."""
    dyf = dy2d.float()
    xf = x2d.float()
    xhat = xf * invvar if rms else (xf - mean) * invvar
    dxhat = dyf * weight.float() if weight is not None else dyf
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    if rms:
        dx = invvar * (dxhat - xhat * m2)
    else:
        m1 = dxhat.mean(dim=-1, keepdim=True)
        dx = invvar * (dxhat - m1 - xhat * m2)
    w_dtype = weight.dtype if weight is not None else torch.float32
    dw = (dyf * xhat).sum(dim=0).to(w_dtype) if weight is not None else None
    db = dyf.sum(dim=0).to(w_dtype) if has_bias else None
    return dx.to(x2d.dtype), dw, db


class _FusedNorm(torch.autograd.Function):
    """LayerNorm/RMSNorm over the rows of a 2-D ``x`` with the optional
    affine parameters, on the kernels or their plain twins. The forward
    saves ``(x, mean, invvar, weight)``; the backward is ``ln_bwd``."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps: float, rms: bool, out_dtype,
                use_kernel: bool):
        fwd = _kernels.ln_fwd if use_kernel else _ln_fwd_plain
        # one op of a name-based remat region (apex_tpu_torch/remat.py)
        out, mean, invvar = region_op(fwd, x2d, weight, bias, eps, rms,
                                      out_dtype)
        ctx.save_for_backward(x2d, mean, invvar, weight)
        ctx.rms = rms
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.use_kernel = use_kernel
        return out

    @staticmethod
    def backward(ctx, dy):
        x2d, mean, invvar, weight = ctx.saved_tensors
        bwd = _kernels.ln_bwd if ctx.use_kernel else _ln_bwd_plain
        dx, dw, db = bwd(dy.contiguous(), x2d, mean, invvar, weight,
                         ctx.rms, ctx.bias_dtype is not None)
        if db is not None:
            db = db.to(ctx.bias_dtype)
        return dx, dw, db, None, None, None, None


def _run(x, weight, bias, normalized_shape, eps, rms: bool, out_dtype,
         use_kernel: Optional[bool]):
    shape = _norm_shape(normalized_shape)
    if tuple(x.shape[-len(shape):]) != shape:
        raise ValueError(f"normalized_shape {shape} does not match input "
                         f"tail {tuple(x.shape)}")
    h = 1
    for d in shape:
        h *= d
    out = _FusedNorm.apply(
        x.reshape(-1, h).contiguous(),
        None if weight is None else weight.reshape(h),
        None if bias is None else bias.reshape(h), float(eps), bool(rms),
        out_dtype, use_kernel_for(use_kernel, x))
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# functional API
# ---------------------------------------------------------------------------

def fused_layer_norm_affine(x, weight, bias, normalized_shape, eps=1e-5,
                            use_kernel: Optional[bool] = None):
    """Affine LayerNorm over the trailing ``normalized_shape`` dims; the
    output takes ``x.dtype`` (the reference requires the weight's to
    match), the weight and bias grads their own dtypes."""
    return _run(x, weight, bias, normalized_shape, eps, False, x.dtype,
                use_kernel)


def fused_layer_norm(x, normalized_shape, eps=1e-5,
                     use_kernel: Optional[bool] = None):
    """LayerNorm without affine parameters."""
    return _run(x, None, None, normalized_shape, eps, False, x.dtype,
                use_kernel)


def fused_rms_norm_affine(x, weight, normalized_shape, eps=1e-5,
                          use_kernel: Optional[bool] = None):
    """RMSNorm with a weight (no bias); output in ``x.dtype``."""
    return _run(x, weight, None, normalized_shape, eps, True, x.dtype,
                use_kernel)


def fused_rms_norm(x, normalized_shape, eps=1e-5,
                   use_kernel: Optional[bool] = None):
    """RMSNorm without a weight."""
    return _run(x, None, None, normalized_shape, eps, True, x.dtype,
                use_kernel)


def mixed_dtype_fused_layer_norm_affine(x, weight, bias, normalized_shape,
                                        eps=1e-5,
                                        use_kernel: Optional[bool] = None):
    """Megatron's mixed-dtype LayerNorm: the output takes the **weight's**
    dtype (fp32 parameters with bf16 activations give fp32)."""
    return _run(x, weight, bias, normalized_shape, eps, False, weight.dtype,
                use_kernel)


def mixed_dtype_fused_rms_norm_affine(x, weight, normalized_shape, eps=1e-5,
                                      use_kernel: Optional[bool] = None):
    """Mixed-dtype RMSNorm: output in the weight's dtype."""
    return _run(x, weight, None, normalized_shape, eps, True, weight.dtype,
                use_kernel)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class FusedLayerNorm(nn.Module):
    """``apex.normalization.FusedLayerNorm``: LayerNorm over the trailing
    ``normalized_shape`` dims, with a unit weight and zero bias when
    ``elementwise_affine``, on ``device`` (default the card; pass
    ``device="cpu"`` for the plain path). ``use_kernel`` as for the
    functions."""

    rms = False
    mixed = False

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 param_dtype: torch.dtype = torch.float32, device="cuda",
                 use_kernel: Optional[bool] = None):
        super().__init__()
        self.normalized_shape = _norm_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.use_kernel = use_kernel
        dev = resolve_device(device)
        self.weight = self.bias = None
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=dev))
            if not self.rms:
                self.bias = nn.Parameter(torch.zeros(
                    self.normalized_shape, dtype=param_dtype, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        out_dtype = w.dtype if (self.mixed and w is not None) else x.dtype
        return _run(x, w, self.bias, self.normalized_shape, self.eps,
                    self.rms, out_dtype, self.use_kernel)

    def extra_repr(self) -> str:
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.elementwise_affine}")


class FusedRMSNorm(FusedLayerNorm):
    """``apex.normalization.FusedRMSNorm``: no bias term."""
    rms = True


class MixedFusedLayerNorm(FusedLayerNorm):
    """fp32 parameters with half inputs; the output takes the weight's
    dtype."""
    mixed = True


class MixedFusedRMSNorm(FusedRMSNorm):
    """The mixed-dtype RMSNorm."""
    mixed = True
