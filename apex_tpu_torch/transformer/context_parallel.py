"""Context parallelism's attention and Megatron-LM sequence parallelism.

Counterpart of ``apex_tpu/transformer/context_parallel.py``. The
attention takes ``(b, h, s/cp, d)`` sequence shards over the process group
of ``axis_name`` (a mesh axis name or a ``ProcessGroup``), the global
sequence being the rank-order concatenation of the shards:

- :func:`ring_attention`: k/v chunks travel round the ring
  (:func:`apex_tpu_torch.parallel._p2p.rotate`, whose backward is the
  reverse hop) and an online ``(m, l, acc)`` softmax merges them in fp32.
  Under ``causal`` a chunk from an earlier rank is seen whole, the
  diagonal one causally and a later one not at all (masked, and merged
  all the same: every rank's autograd graph then holds every hop, so
  every rank posts the same reverse hops in the backward). Every rank
  makes ``cp`` hops, the last one bringing each chunk home.
  ``remat=True`` recomputes only the chunk merge in the backward
  (``torch.utils.checkpoint``), never a hop;
- :func:`ulysses_attention`: two tiled all-to-alls
  (:func:`apex_tpu_torch.parallel._p2p.all_to_all`) turn sequence shards
  into head shards of the whole sequence and back; between them
  ``attention_fn`` (default the port's
  :func:`~apex_tpu_torch.ops.flash_attention.flash_attention`, the flash
  kernels on the card) runs on full sequences.

The sequence-parallel regions are ``torch.autograd.Function`` s over the
process group of ``axis_name`` (``parallel_state.resolve_axis``; default
the tensor axis):

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
``ValueError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from apex_tpu_torch.ops.flash_attention import NEG_INF
from apex_tpu_torch.parallel._p2p import all_to_all, rotate
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_gather, reduce_scatter, split, tensor_group)

__all__ = ["ring_attention", "ulysses_attention",
           "scatter_to_sequence_parallel_region",
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


# -- context parallelism's attention -----------------------------------------

def _chunk_update(qf, m, l, acc, k_c, v_c, scale: float, allowed):
    """One chunk of the online softmax (reference :65-92), in fp32;
    ``allowed``: the causal mask of the chunk's scores, or None."""
    s = torch.matmul(qf, k_c.float().transpose(-1, -2)) * scale
    if allowed is not None:
        s = torch.where(allowed, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    if allowed is not None:
        # a masked row has m_new == NEG_INF and exp(0) == 1 there
        p = torch.where(allowed, p, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.matmul(p, v_c.float())
    return m_new, l, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name, causal: bool = False,
                   softmax_scale: Optional[float] = None,
                   remat: bool = True) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis_name``: ``q``/``k``/``v``
    are this rank's ``(b, h, s_local, d)`` shards; returns the output
    shard, in ``q``'s dtype (the chunk math is fp32)."""
    b, h, s_loc, d = q.shape
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    group = tensor_group(axis_name)
    cp, rank = dist.get_world_size(group), dist.get_rank(group)
    qf = q.float()
    m = torch.full((b, h, s_loc, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32,
                      device=q.device)
    if causal:
        diagonal = torch.ones(s_loc, s_loc, dtype=torch.bool,
                              device=q.device).tril()
        later = torch.zeros_like(diagonal)
    k_c, v_c = k, v
    for t in range(cp):
        # after t hops this rank holds the chunk of rank (rank - t) mod cp
        kv_rank = (rank - t) % cp
        allowed = None
        if causal and kv_rank >= rank:
            # a later chunk is masked whole but still merged, so that
            # every rank's backward runs every hop's
            allowed = diagonal if kv_rank == rank else later
        args = (qf, m, l, acc, k_c, v_c, softmax_scale, allowed)
        if remat:
            m, l, acc = torch.utils.checkpoint.checkpoint(
                _chunk_update, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_update(*args)
        k_c, v_c = rotate((k_c, v_c), group, 1)
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name, causal: bool = False,
                      softmax_scale: Optional[float] = None,
                      attention_fn=None) -> torch.Tensor:
    """DeepSpeed-Ulysses: ``(b, h, s/cp, d)`` shards in and out, as
    :func:`ring_attention`; inside, each rank attends ``h/cp`` heads over
    the whole sequence. ``h % cp`` raises ``ValueError``."""
    group = tensor_group(axis_name)
    cp = dist.get_world_size(group)
    heads = q.shape[1]
    if heads % cp:
        raise ValueError(f"num heads {heads} not divisible by cp={cp}")
    if attention_fn is None:
        from apex_tpu_torch.ops.flash_attention import flash_attention
        attention_fn = flash_attention
    # sequence shards -> head shards of the whole sequence: split the
    # heads, concatenate the received chunks along the sequence
    qh, kh, vh = (all_to_all(x, group, 1, 2) for x in (q, k, v))
    out = attention_fn(qh, kh, vh, causal=causal,
                       softmax_scale=softmax_scale)
    return all_to_all(out, group, 2, 1)
