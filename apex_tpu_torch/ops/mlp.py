"""Fused MLP and dense layers for the port.

Counterpart of ``apex_tpu/ops/mlp.py`` (apex's ``apex.mlp.MLP`` and
``apex.fused_dense``). The reference has no Pallas kernel here: each GEMM,
bias and activation chain is left to the compiler, and so it is here
(cuBLAS or the CPU's GEMM). Two rules of the reference stay:

- a GEMM takes the activations as they are and the weights in fp32 and
  returns fp32: ``x @ w.T`` of bf16 ``x`` and fp32 ``w`` is computed in
  fp32, the product of the exact values, as the reference's
  ``dot_general(preferred_element_type=float32)`` does (rounding ``w`` to
  bf16 first would move a 4 x 8 product by ~1e-2);
- ``mlp_forward`` applies the activation after *every* layer, the last
  included, as apex's ``MlpFunction`` does; each layer's output is cast
  back to the input's dtype.

``fused_dense_gelu_dense`` is GEMM + bias + tanh GELU + GEMM + bias (the
cuBLASLt GELU epilogue's approximation). The modules hold fp32 weights
``(out, in)`` and biases, initialized uniform in ``±1/sqrt(fan_in)`` from a
CPU ``torch.Generator`` (``init``); the state dict names follow apex
(``weight_0``/``bias_0``, ...) for ``MLP`` and the reference's trees
(``dense1.weight``, ...) for ``FusedDenseGeluDense``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device

__all__ = ["MLP", "FusedDense", "FusedDenseGeluDense", "mlp_forward",
           "fused_dense", "fused_dense_gelu_dense"]

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


def _dense(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ w.T (+ b)`` of the exact values, in fp32."""
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32).t())
    if b is not None:
        y = y + b.to(torch.float32)
    return y


def mlp_forward(params: Sequence[Tuple[torch.Tensor,
                                       Optional[torch.Tensor]]],
                x: torch.Tensor, activation: str = "relu") -> torch.Tensor:
    """A chain of ``(weight, bias)`` layers, ``activation`` after each,
    the last included."""
    act = _ACTIVATIONS[activation]
    y = x
    for w, b in params:
        y = act(_dense(y, w, b)).to(x.dtype)
    return y


def fused_dense(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """GEMM + bias (``fused_dense_cuda.linear_bias_forward``), in
    ``x.dtype``."""
    return _dense(x, weight, bias).to(x.dtype)


def fused_dense_gelu_dense(x, w1, b1, w2, b2) -> torch.Tensor:
    """GEMM + bias + tanh GELU + GEMM + bias
    (``linear_gelu_linear_forward``), in ``x.dtype``."""
    h = F.gelu(_dense(x, w1, b1), approximate="tanh")
    return _dense(h.to(x.dtype), w2, b2).to(x.dtype)


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    vals = torch.empty(tuple(t.shape), dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)
    with torch.no_grad():
        t.copy_(vals)


class MLP(nn.Module):
    """``apex.mlp.MLP(mlp_sizes, bias=True, activation='relu')`` on
    ``device`` (default the card)."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu",
                 param_dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        if len(mlp_sizes) < 2:
            raise ValueError("mlp_sizes must have at least 2 entries")
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f"activation must be one of {list(_ACTIVATIONS)}")
        self.mlp_sizes = tuple(int(s) for s in mlp_sizes)
        self.bias = bias
        self.activation = activation
        dev = resolve_device(device)
        for i, (fan_in, fan_out) in enumerate(zip(self.mlp_sizes[:-1],
                                                  self.mlp_sizes[1:])):
            self.register_parameter(f"weight_{i}", nn.Parameter(torch.empty(
                fan_out, fan_in, dtype=param_dtype, device=dev)))
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.empty(
                fan_out, dtype=param_dtype, device=dev)) if bias else None)

    def layers(self) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """The ``(weight, bias)`` pairs, in order (the reference's params
        list)."""
        return [(getattr(self, f"weight_{i}"), getattr(self, f"bias_{i}"))
                for i in range(len(self.mlp_sizes) - 1)]

    def init(self, generator: torch.Generator) -> "MLP":
        """Weights and biases uniform in ``±1/sqrt(fan_in)``."""
        for w, b in self.layers():
            bound = 1.0 / math.sqrt(w.shape[1])
            _uniform_(w, bound, generator)
            if b is not None:
                _uniform_(b, bound, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self.layers(), x, self.activation)


class FusedDense(nn.Module):
    """``apex.fused_dense.FusedDense`` on ``device`` (default the card)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, param_dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=param_dtype, device=dev))
        self.bias = (nn.Parameter(torch.empty(
            out_features, dtype=param_dtype, device=dev)) if bias else None)

    def init(self, generator: torch.Generator) -> "FusedDense":
        bound = 1.0 / math.sqrt(self.in_features)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_dense(x, self.weight, self.bias)


class FusedDenseGeluDense(nn.Module):
    """``apex.fused_dense.FusedDenseGeluDense``: ``dense1``, tanh GELU,
    ``dense2``; ``bias=False`` raises, as in the reference."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, bias: bool = True,
                 param_dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        if not bias:
            raise ValueError("FusedDenseGeluDense requires bias=True "
                             "(as in the reference)")
        self.dense1 = FusedDense(in_features, intermediate_features, True,
                                 param_dtype, device)
        self.dense2 = FusedDense(intermediate_features, out_features, True,
                                 param_dtype, device)

    def init(self, generator: torch.Generator) -> "FusedDenseGeluDense":
        self.dense1.init(generator)
        self.dense2.init(generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_dense_gelu_dense(
            x, self.dense1.weight, self.dense1.bias, self.dense2.weight,
            self.dense2.bias)
