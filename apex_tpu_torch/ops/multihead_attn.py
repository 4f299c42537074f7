"""Fused multi-head attention modules for the port: self and
encoder-decoder attention, with the optional pre-LayerNorm + residual
("norm-add") wiring.

Counterpart of ``apex_tpu/ops/multihead_attn.py`` (apex's
``apex.contrib.multihead_attn``). Tensors are sequence-first, ``(T, B,
H)``. The attention core is the port's :func:`~apex_tpu_torch.ops.
flash_attention.flash_attention` (on CUDA tensors the ``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv`` kernels: mask, softmax and dropout
inside the kernel) and the norm of ``include_norm_add`` is
:func:`~apex_tpu_torch.normalization.fused_layer_norm_affine` (the
``ln_fwd``/``ln_bwd`` kernels), so ``include_norm_add`` computes ``x +
attn(LN(x))``; the projections are ``x @ w.T`` with the weight cast to
the activations' dtype, as in the reference. A key padding mask ``(B,
T)``, ``True`` at padding, becomes the ``(B, 1, 1, T)`` fp32 score bias
``-10000`` at padding, 0 elsewhere.

Parameters mirror the reference's tree: ``qkv`` (self) or ``q`` and
``kv`` (encoder-decoder), ``out``, and ``lyr_nrm`` with
``include_norm_add``, each holding ``weight`` (and ``bias`` with
``bias=True``); ``init`` draws the weights Xavier-uniform from a CPU
``torch.Generator``, biases 0, the norm's weight 1. Attention dropout runs
only where a ``dropout_seed`` (an int) is given, as the reference's runs
only with a ``dropout_rng``: the kernels' counter hash keyed by the seed
gives the mask the reference draws for the same int seed bit for bit.
``use_kernel`` is the port's contract (``None``: the kernels iff the
tensors lie on a CUDA device).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn"]


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    # (T, B, H) -> (B, heads, T, dh)
    t, b, h = x.shape
    return x.reshape(t, b, heads, h // heads).permute(1, 2, 0, 3)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    # (B, heads, T, dh) -> (T, B, H)
    b, nh, t, dh = x.shape
    return x.permute(2, 0, 1, 3).reshape(t, b, nh * dh)


def _mask_bias(key_padding_mask: Optional[torch.Tensor]):
    """``(B, T)`` True at padding -> the additive ``(B, 1, 1, T)`` fp32
    bias, ``-10000`` at padding."""
    if key_padding_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32,
                       device=key_padding_mask.device)
    return torch.where(key_padding_mask.bool()[:, None, None, :], -10000.0,
                       zero)


def _proj(x: torch.Tensor, p: nn.Module) -> torch.Tensor:
    y = x @ p.weight.to(x.dtype).t()
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


class _Weights(nn.Module):
    """One projection's (or the norm's) ``weight`` and optional
    ``bias``."""

    def __init__(self, shape, bias: bool, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, dtype=dtype,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(shape[0], dtype=dtype,
                                              device=device))
                     if bias else None)


class _MultiheadBase(nn.Module):

    def __init__(self, embed_dim: int, num_heads: int, dropout: float,
                 bias: bool, include_norm_add: bool,
                 param_dtype: torch.dtype, device,
                 use_kernel: Optional[bool]):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"num_heads ({num_heads}) must divide embed_dim "
                f"({embed_dim})")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.use_bias = bias
        self.include_norm_add = include_norm_add
        self.use_kernel = use_kernel
        self._dtype = param_dtype
        self._device = resolve_device(device)
        if include_norm_add:
            self.lyr_nrm = _Weights((embed_dim,), True, param_dtype,
                                    self._device)

    def _weights(self, rows: int) -> _Weights:
        return _Weights((rows, self.embed_dim), self.use_bias, self._dtype,
                        self._device)

    def _init(self, names, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name in names:
                w = getattr(self, name).weight
                fan_out, fan_in = w.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                w.copy_(torch.empty(tuple(w.shape)).uniform_(
                    -bound, bound, generator=generator))
                if getattr(self, name).bias is not None:
                    getattr(self, name).bias.zero_()
            if self.include_norm_add:
                self.lyr_nrm.weight.fill_(1.0)
                self.lyr_nrm.bias.zero_()

    def _maybe_norm(self, x: torch.Tensor) -> torch.Tensor:
        if not self.include_norm_add:
            return x
        return fused_layer_norm_affine(
            x, self.lyr_nrm.weight.to(x.dtype), self.lyr_nrm.bias.to(x.dtype),
            self.embed_dim, use_kernel=self.use_kernel)

    def _attend(self, q, k, v, key_padding_mask, causal: bool,
                dropout_seed: Optional[int]) -> torch.Tensor:
        h = self.num_heads
        rate = self.dropout if dropout_seed is not None else 0.0
        return flash_attention(
            _heads(q, h), _heads(k, h), _heads(v, h),
            bias=_mask_bias(key_padding_mask), causal=causal,
            use_kernel=self.use_kernel, dropout_rate=rate,
            dropout_seed=dropout_seed)

    def _out_proj(self, ctx: torch.Tensor,
                  residual: torch.Tensor) -> torch.Tensor:
        out = _proj(_unheads(ctx), self.out)
        return residual + out if self.include_norm_add else out


class SelfMultiheadAttn(_MultiheadBase):
    """apex's ``SelfMultiheadAttn``: ``forward(x, key_padding_mask=None,
    attn_mask_causal=False, dropout_seed=None)`` with ``x`` ``(T, B, H)``
    returns ``(T, B, H)``; one ``qkv`` in-projection."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 param_dtype: torch.dtype = torch.float32, device="cuda",
                 use_kernel: Optional[bool] = None):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, param_dtype, device, use_kernel)
        self.qkv = self._weights(3 * embed_dim)
        self.out = self._weights(embed_dim)

    def init(self, generator: torch.Generator) -> "SelfMultiheadAttn":
        self._init(("qkv", "out"), generator)
        return self

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask_causal: bool = False,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        residual = x
        q, k, v = torch.chunk(_proj(self._maybe_norm(x), self.qkv), 3,
                              dim=-1)
        ctx = self._attend(q, k, v, key_padding_mask, attn_mask_causal,
                           dropout_seed)
        return self._out_proj(ctx, residual)


class EncdecMultiheadAttn(_MultiheadBase):
    """apex's ``EncdecMultiheadAttn``: queries from the decoder stream,
    keys and values from the encoder output (separate ``q`` and ``kv``
    in-projections); ``forward(query, key_value, key_padding_mask=None,
    dropout_seed=None)``, the mask over the keys."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 param_dtype: torch.dtype = torch.float32, device="cuda",
                 use_kernel: Optional[bool] = None):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, param_dtype, device, use_kernel)
        self.q = self._weights(embed_dim)
        self.kv = self._weights(2 * embed_dim)
        self.out = self._weights(embed_dim)

    def init(self, generator: torch.Generator) -> "EncdecMultiheadAttn":
        self._init(("q", "kv", "out"), generator)
        return self

    def forward(self, query: torch.Tensor, key_value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        residual = query
        q = _proj(self._maybe_norm(query), self.q)
        k, v = torch.chunk(_proj(key_value, self.kv), 2, dim=-1)
        ctx = self._attend(q, k, v, key_padding_mask, False, dropout_seed)
        return self._out_proj(ctx, residual)
