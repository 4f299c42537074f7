"""Tensor-parallel layers at tp=1.

Counterpart of ``apex_tpu/transformer/tensor_parallel/layers.py``. At one
rank the layers are plain linear and embedding modules; they keep the
reference's parameter names and its mixed-dtype rule so the weight bridge
maps one to one: the product ``x @ w.T`` accumulates in fp32 (bf16
activations against fp32 weights are exact in fp32), the result is cast to
the activation dtype, and the bias is added after that cast. Parameters
are trainable; autograd carries the grads back through the same casts
(fp32 products, then the cast to the parameter's dtype). The layers live on
``device``, by default the card (``"cuda"``, which raises when there is
none: pass ``device="cpu"`` for the plain CPU path). tp > 1 raises:
sharded layers come with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "init_method_normal"]


def init_method_normal(sigma: float) -> Callable:
    """``init_(tensor, generator)`` fills ``tensor`` in place with
    ``N(0, sigma**2)`` draws from a CPU ``torch.Generator`` (drawn on the
    host, so a seed gives the same weights on every device)."""
    def init_(tensor: torch.Tensor, generator: torch.Generator):
        vals = torch.randn(tuple(tensor.shape), generator=generator,
                           dtype=torch.float32) * sigma
        with torch.no_grad():
            tensor.copy_(vals)
        return tensor
    return init_


def _require_tp1(world_size: int) -> None:
    if world_size != 1:
        raise NotImplementedError(
            f"tensor parallelism (world_size={world_size}) lands with the "
            "multi-GPU slice; the port runs tp=1")


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` with fp32 accumulation, cast back to ``x.dtype``."""
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int, bias: bool,
                 init_method: Optional[Callable], params_dtype,
                 world_size: int, device):
        super().__init__()
        _require_tp1(world_size)
        self.input_size = input_size
        self.output_size = output_size
        self.init_method = init_method or init_method_normal(0.02)
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            output_size, input_size, dtype=params_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(
            output_size, dtype=params_dtype, device=device))
            if bias else None)

    def init(self, generator: torch.Generator) -> None:
        self.init_method(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        out = _dense(x, self.weight)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out, None


class ColumnParallelLinear(_Linear):
    """``Y = X A^T + b``; returns ``(out, None)`` like the reference's
    ``(out, bias_out)``."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 init_method: Optional[Callable] = None,
                 params_dtype=torch.float32, world_size: int = 1,
                 device="cuda"):
        super().__init__(input_size, output_size, bias, init_method,
                         params_dtype, world_size, device)


class RowParallelLinear(_Linear):
    """``Y = X A^T + b`` with the bias added once, after the (here
    trivial) reduction."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 init_method: Optional[Callable] = None,
                 params_dtype=torch.float32, world_size: int = 1,
                 device="cuda"):
        super().__init__(input_size, output_size, bias, init_method,
                         params_dtype, world_size, device)


class VocabParallelEmbedding(nn.Module):
    """Embedding lookup; ``weight`` is ``(vocab, hidden)``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 init_method: Optional[Callable] = None,
                 params_dtype=torch.float32, world_size: int = 1,
                 device="cuda"):
        super().__init__()
        _require_tp1(world_size)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.init_method = init_method or init_method_normal(0.02)
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, dtype=params_dtype,
            device=resolve_device(device)))

    def init(self, generator: torch.Generator) -> None:
        self.init_method(self.weight, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]
