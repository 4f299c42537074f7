"""Tensor-parallel sharded layers.

Counterpart of ``apex_tpu/transformer/tensor_parallel/layers.py``.
Reference: ``reference:apex/transformer/tensor_parallel/layers.py``:
``VocabParallelEmbedding`` (:154-256, the vocab-range mask and an
all-reduce), ``ColumnParallelLinear`` (:377-538) and
``RowParallelLinear`` (:541-663).

Each rank holds only its own shard as an ``nn.Parameter``: Column
``(out / tp, in)`` with its bias slice ``(out / tp,)``, Row ``(out, in /
tp)`` with a copy of the whole bias ``(out,)``, the embedding ``(vocab /
tp, h)``. ``world_size`` defaults to the tensor group's size (1 without
an installed mesh); a size above 1 must be the tensor group's, and the
rank is the tensor rank of :mod:`~apex_tpu_torch.transformer.
parallel_state`. ``init(generator)`` draws the fp32 master weight from
the CPU ``generator``, as the reference's
``_initialize_affine_weight_cpu`` does (:56-151), and keeps this rank's
shard of it: a seed gives the tp = 1 weights, cut up.

Numerics are the reference's mixed-dtype rule: the product ``x @ w.T``
accumulates in fp32 (the operands widened first), the result is cast to
the activation dtype, and the bias is added after that cast. The
collectives come from :mod:`.mappings` and :mod:`.collective_matmul`:

- Column: the input is copied into the region (all-reduce backward), or
  under ``sequence_parallel`` the sequence shards are all-gathered
  (reduce-scatter backward), the gather ring-decomposed under the partial
  GEMMs with ``tp_comm_overlap``; ``gather_output`` all-gathers the
  output columns, and ``skip_bias_add`` returns the bias apart.
- Row: ``input_is_parallel=False`` scatters the input's last dim; the
  partial products are all-reduced, or under ``sequence_parallel``
  reduce-scattered along the sequence (all-gather backward), ring-reduced
  with ``tp_comm_overlap``.
- Both sequence-parallel pairs, fused or ringed, run
  :func:`.collective_matmul.sequence_parallel_matmul`: the same partial
  GEMMs, one a sequence chunk, with one collective or with ring hops
  between them, so at tp = 2 in fp32 the two agree bit for bit on any
  backend (a whole-sequence GEMM in the fused path against the ring's
  chunk GEMMs left the grads up to 2.98e-8 apart on an H100 under
  cuBLAS).
  At tp > 1 the bias is folded into every rank's partial as ``b / tp``
  before the reduction, with its gradient scaled back by ``tp``, so each
  rank's bias copy gets the full gradient (the reference adds it after
  the reduce, :649-657; the JAX package's ``_scale_grad`` fold, copied so
  the two agree).
- ``tp_comm_overlap`` without ``sequence_parallel`` raises: only the
  sequence-parallel pairs are dependent collectives.

At tp = 1 the layers are plain linear and embedding modules.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.collective_matmul import (
    sequence_parallel_matmul)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_tensor_model_parallel_region, tensor_group)
from apex_tpu_torch.transformer.utils import divide

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


def tensor_world_size(world_size: Optional[int] = None) -> int:
    """``world_size``, or the tensor group's size (1 with no mesh
    installed). A size above 1 must be the tensor group's: with no mesh,
    or another size, it raises ``ValueError``."""
    if world_size is None:
        if parallel_state.model_parallel_is_initialized():
            return parallel_state.get_tensor_model_parallel_world_size()
        return 1
    if world_size > 1:
        group_size = dist.get_world_size(tensor_group())
        if group_size != world_size:
            raise ValueError(
                f"world_size={world_size} but the tensor group has "
                f"{group_size} ranks")
    return world_size


def tensor_rank(world_size: int) -> int:
    return (0 if world_size == 1
            else parallel_state.get_tensor_model_parallel_rank())


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` with fp32 accumulation, cast back to ``x.dtype``."""
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


def _master_shard(init_method: Callable, shape: Tuple[int, int],
                  generator: torch.Generator, dim: int, rank: int,
                  parts: int) -> torch.Tensor:
    """Rank ``rank``'s ``1/parts`` slice of ``dim`` of an fp32 master
    weight of ``shape`` drawn by ``init_method``."""
    master = torch.empty(shape, dtype=torch.float32)
    init_method(master, generator)
    return master.chunk(parts, dim)[rank]


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient multiplied by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int, bias: bool,
                 init_method: Optional[Callable], params_dtype,
                 world_size: Optional[int], shard_dim: int,
                 sequence_parallel: bool, seq_axis: int,
                 tp_comm_overlap: bool, skip_bias_add: bool, device,
                 what: str):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.init_method = init_method or init_method_normal(0.02)
        self.world_size = tensor_world_size(world_size)
        self.rank = tensor_rank(self.world_size)
        self.shard_dim = shard_dim
        self.sequence_parallel = sequence_parallel
        self.seq_axis = seq_axis
        self.skip_bias_add = skip_bias_add
        if tp_comm_overlap and not sequence_parallel:
            raise ValueError(
                "tp_comm_overlap requires sequence_parallel=True: only the "
                f"SP {what} pair is a dependent collective")
        self.tp_comm_overlap = tp_comm_overlap
        shape = [output_size, input_size]
        shape[shard_dim] = divide(shape[shard_dim], self.world_size)
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            *shape, dtype=params_dtype, device=device))
        bias_size = shape[0]
        self.bias = (nn.Parameter(torch.zeros(
            bias_size, dtype=params_dtype, device=device))
            if bias else None)

    def init(self, generator: torch.Generator) -> None:
        shard = _master_shard(self.init_method,
                              (self.output_size, self.input_size),
                              generator, self.shard_dim, self.rank,
                              self.world_size)
        with torch.no_grad():
            self.weight.copy_(shard)
            if self.bias is not None:
                self.bias.zero_()

    def _sp_matmul(self, x: torch.Tensor, column: bool, fold=None):
        """The sequence-parallel GEMM pair, fused or ringed."""
        return sequence_parallel_matmul(
            x, self.weight, self.seq_axis, column, self.tp_comm_overlap,
            fold).to(x.dtype)


class ColumnParallelLinear(_Linear):
    """``Y = X A^T + b`` with ``A`` sharded along its output features;
    ``forward`` returns ``(out, bias)`` like the reference, the bias
    ``None`` unless ``skip_bias_add``."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 gather_output: bool = True,
                 init_method: Optional[Callable] = None,
                 skip_bias_add: bool = False, params_dtype=torch.float32,
                 world_size: Optional[int] = None,
                 sequence_parallel: bool = False, seq_axis: int = 1,
                 tp_comm_overlap: bool = False, device="cuda"):
        super().__init__(input_size, output_size, bias, init_method,
                         params_dtype, world_size, 0, sequence_parallel,
                         seq_axis, tp_comm_overlap, skip_bias_add, device,
                         "gather->GEMM")
        self.gather_output = gather_output
        self.output_size_per_partition = self.weight.shape[0]

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        tp = self.world_size
        if tp > 1 and self.sequence_parallel:
            out = self._sp_matmul(x, column=True)
        else:
            if tp > 1:
                x = copy_to_tensor_model_parallel_region(x)
            out = _dense(x, self.weight)
        b = None
        if self.bias is not None:
            if self.skip_bias_add:
                b = self.bias
            else:
                out = out + self.bias.to(out.dtype)
        if self.gather_output and tp > 1:
            out = gather_from_tensor_model_parallel_region(out)
            if b is not None:
                b = gather_from_tensor_model_parallel_region(b)
        return out, b


class RowParallelLinear(_Linear):
    """``Y = X A^T + b`` with ``A`` sharded along its input features; the
    partial products are summed over the tensor group and the bias is
    added once."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 input_is_parallel: bool = False,
                 init_method: Optional[Callable] = None,
                 skip_bias_add: bool = False, params_dtype=torch.float32,
                 world_size: Optional[int] = None,
                 sequence_parallel: bool = False, seq_axis: int = 1,
                 tp_comm_overlap: bool = False, device="cuda"):
        super().__init__(input_size, output_size, bias, init_method,
                         params_dtype, world_size, 1, sequence_parallel,
                         seq_axis, tp_comm_overlap, skip_bias_add, device,
                         "GEMM->reduce-scatter")
        self.input_is_parallel = input_is_parallel
        self.input_size_per_partition = self.weight.shape[1]

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        tp = self.world_size
        b = self.bias if self.skip_bias_add else None
        if tp == 1:
            out = _dense(x, self.weight)
            if self.bias is not None and not self.skip_bias_add:
                out = out + self.bias.to(out.dtype)
            return out, b
        if not self.input_is_parallel:
            x = scatter_to_tensor_model_parallel_region(x)
        fold = None
        if self.bias is not None and not self.skip_bias_add:
            fold = _ScaleGrad.apply(self.bias.float(), tp) / tp
        if self.sequence_parallel:
            return self._sp_matmul(x, column=False, fold=fold), b
        partial = _dense(x, self.weight)
        if fold is not None:
            partial = partial + fold.to(partial.dtype)
        return reduce_from_tensor_model_parallel_region(partial), b


class VocabParallelEmbedding(nn.Module):
    """Embedding sharded along the vocab: each rank looks up the ids in
    its range, zeroes the rest, and the all-reduce assembles the rows.
    ``weight`` is ``(vocab / tp, hidden)``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 init_method: Optional[Callable] = None,
                 params_dtype=torch.float32,
                 world_size: Optional[int] = None, device="cuda"):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.init_method = init_method or init_method_normal(0.02)
        self.world_size = tensor_world_size(world_size)
        self.rank = tensor_rank(self.world_size)
        self.num_embeddings_per_partition = divide(num_embeddings,
                                                   self.world_size)
        self.weight = nn.Parameter(torch.empty(
            self.num_embeddings_per_partition, embedding_dim,
            dtype=params_dtype, device=resolve_device(device)))

    def init(self, generator: torch.Generator) -> None:
        shard = _master_shard(self.init_method,
                              (self.num_embeddings, self.embedding_dim),
                              generator, 0, self.rank, self.world_size)
        with torch.no_grad():
            self.weight.copy_(shard)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.world_size == 1:
            return self.weight[ids]
        per = self.num_embeddings_per_partition
        start = self.rank * per
        # the vocab-range mask (:221-239)
        in_range = (ids >= start) & (ids < start + per)
        rows = self.weight[torch.where(in_range, ids - start, 0)]
        rows = torch.where(in_range[..., None], rows, 0.0)
        return reduce_from_tensor_model_parallel_region(rows)
