"""Megatron-LM sequence parallelism: the regions where norms, dropout and
residuals run on sequence shards over the tensor group.

Counterpart of the sequence-parallel part of
``apex_tpu/transformer/context_parallel.py`` (:172-218). Each region is a
``torch.autograd.Function`` over the process group of ``axis_name``
(``parallel_state.resolve_axis``; default the tensor axis):

- :func:`scatter_to_sequence_parallel_region`: keep this rank's slice of
  ``seq_axis`` forward, all-gather the gradient backward;
- :func:`gather_from_sequence_parallel_region`: all-gather ``seq_axis``
  forward; backward, the gradient is reduce-scattered, or, with
  ``invariant=True``, this rank's slice of it is kept;
- :func:`reduce_scatter_to_sequence_parallel_region`: the rank-sum,
  scattered along ``seq_axis``, forward; all-gather backward.

``invariant`` says what the gathered tensor's gradient holds on each
rank. ``False``: a partial, this rank's share of the gradient (the
gathered sequence feeds a column-sharded GEMM, so each rank's backward
sees only its columns); the backward sums the partials and scatters them
(a reduce-scatter). ``True``: the whole gradient, the same on every rank
(the gathered sequence feeds replicated work, or its consumer's backward
already summed over the group, as the tied head's copy-to-region does);
the backward keeps this rank's slice. In the JAX package the same
argument types the gathered value device-invariant, whose cotangent JAX
then sums before the transpose takes the slice: the two spellings give
the same gradients.

The reference's layout is ``(s, b, h)``, so ``seq_axis`` defaults to 0;
the port's models pass 1. A sequence the group does not divide raises
``ValueError``. ``ring_attention`` and ``ulysses_attention`` come with
context parallelism (queue item A5d).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_gather, reduce_scatter, split, tensor_group)

__all__ = ["scatter_to_sequence_parallel_region",
           "gather_from_sequence_parallel_region",
           "reduce_scatter_to_sequence_parallel_region"]


class _ScatterToSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return split(x, group, dim, "sequence scatter")

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherFromSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, invariant):
        ctx.group, ctx.dim, ctx.invariant = group, dim, invariant
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.invariant:
            return split(g, ctx.group, ctx.dim), None, None, None
        return reduce_scatter(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatterToSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def scatter_to_sequence_parallel_region(x: torch.Tensor,
                                        axis_name=TENSOR_AXIS,
                                        seq_axis: int = 0) -> torch.Tensor:
    """This rank's slice of the sequence; all-gather backward. Entering
    an SP region."""
    return _ScatterToSequence.apply(x, tensor_group(axis_name),
                                    seq_axis % x.dim())


def gather_from_sequence_parallel_region(x: torch.Tensor,
                                         axis_name=TENSOR_AXIS,
                                         seq_axis: int = 0,
                                         invariant: bool = False
                                         ) -> torch.Tensor:
    """All-gather the sequence shards; backward as the module docstring
    says for ``invariant``. Leaving an SP region."""
    return _GatherFromSequence.apply(x, tensor_group(axis_name),
                                     seq_axis % x.dim(), invariant)


def reduce_scatter_to_sequence_parallel_region(x: torch.Tensor,
                                               axis_name=TENSOR_AXIS,
                                               seq_axis: int = 0
                                               ) -> torch.Tensor:
    """The rank-sum of ``x``, this rank's sequence shard of it (the
    RowParallel output under SP); all-gather backward."""
    return _ReduceScatterToSequence.apply(x, tensor_group(axis_name),
                                          seq_axis % x.dim())
