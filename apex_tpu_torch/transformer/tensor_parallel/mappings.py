"""Tensor-parallel collective mappings.

Counterpart of ``apex_tpu/transformer/tensor_parallel/mappings.py``.
Reference: ``reference:apex/transformer/tensor_parallel/mappings.py``, four
autograd Functions pairing a forward collective with its transpose:

- copy: identity forward, all-reduce backward (:79);
- reduce: all-reduce forward, identity backward (:95);
- scatter: keep this rank's slice of the last dim forward, all-gather
  backward (:111);
- gather: all-gather along the last dim forward, keep this rank's slice
  backward (:127).

The JAX package gets these backward rules from JAX's varying-axes types;
torch autograd has no such notion, so each mapping here is a
``torch.autograd.Function`` with the reference's pair written out. Every
collective runs over the tensor group,
``parallel_state.resolve_axis("tensor")``, which raises ``ValueError``
before :func:`~apex_tpu_torch.transformer.parallel_state.
initialize_model_parallel` (an unbound axis, as in the reference). At a
tensor group of one rank each mapping is the identity.

The helpers ``all_reduce``, ``all_gather``, ``reduce_scatter`` and
``split`` (along any dim, in rank order) are shared with the sequence-
parallel regions (:mod:`apex_tpu_torch.transformer.context_parallel`),
the sharded layers and the vocab-parallel cross-entropy. Each works on a
copy: a collective never writes into its caller's tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS

__all__ = [
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
]


def tensor_group(axis_name=TENSOR_AXIS):
    """The process group of ``axis_name`` (default the tensor axis)."""
    return parallel_state.resolve_axis(axis_name)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    out = x.contiguous().clone()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    world = dist.get_world_size(group)
    if world == 1:
        return x.contiguous().clone()
    # gloo gathers into the concatenation along dim 0 only
    out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return torch.cat(out.chunk(world, 0), dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank-sum of ``x``, this rank's ``1/world`` slice of ``dim``."""
    world = dist.get_world_size(group)
    _check_divisible(x, dim, world, "reduce_scatter")
    if world == 1:
        return x.contiguous().clone()
    # gloo scatters from the concatenation along dim 0 only
    chunks = x.chunk(world, dim)
    flat = torch.cat(chunks, 0) if dim else x.contiguous()
    out = torch.empty(chunks[0].shape, dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out


def split(x: torch.Tensor, group, dim: int, what: str = "split"
          ) -> torch.Tensor:
    """This rank's ``1/world`` slice of ``dim`` (a copy)."""
    world = dist.get_world_size(group)
    _check_divisible(x, dim, world, what)
    chunk = x.shape[dim] // world
    return x.narrow(dim, dist.get_rank(group) * chunk, chunk).contiguous()


def _check_divisible(x: torch.Tensor, dim: int, world: int,
                     what: str) -> None:
    # a floor-divide would silently drop the trailing x.shape[dim] % world
    # elements on every rank
    if x.shape[dim] % world:
        raise ValueError(
            f"{what}: dim {dim} of size {x.shape[dim]} is not divisible "
            f"by tensor parallel size {world}")


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        tp = dist.get_world_size(group)
        if x.shape[-1] % tp:
            raise ValueError(
                f"scatter_to_tensor_model_parallel_region: last dim of size "
                f"{x.shape[-1]} is not divisible by tensor parallel size "
                f"{tp}")
        return split(x, group, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, g.dim() - 1), None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return split(g, ctx.group, g.dim() - 1), None


def copy_to_tensor_model_parallel_region(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward all-reduces the gradient (:79-92)."""
    return _CopyToRegion.apply(x, tensor_group())


def reduce_from_tensor_model_parallel_region(x: torch.Tensor
                                             ) -> torch.Tensor:
    """All-reduce forward; identity backward (:95-108)."""
    return _ReduceFromRegion.apply(x, tensor_group())


def scatter_to_tensor_model_parallel_region(x: torch.Tensor
                                            ) -> torch.Tensor:
    """This rank's slice of the last dim forward; the backward gathers
    the slices' gradients (:111-124). A last dim that the tensor group
    does not divide raises ``ValueError``."""
    return _ScatterToRegion.apply(x, tensor_group())


def gather_from_tensor_model_parallel_region(x: torch.Tensor
                                             ) -> torch.Tensor:
    """All-gather along the last dim forward; the backward keeps this
    rank's slice of the (replicated) gradient (:127-140)."""
    return _GatherFromRegion.apply(x, tensor_group())
