"""Ring-decomposed collective matmuls: the sequence-parallel GEMMs with
their dependent collectives cut into ``tp`` ring steps.

Counterpart of ``apex_tpu/transformer/tensor_parallel/collective_matmul.py``
(after Wang et al., ASPLOS 2023, and Megatron-LM's ``tp_comm_overlap``).
Under sequence parallelism the ColumnParallel GEMM consumes an all-gather
of the sequence and the RowParallel GEMM feeds a reduce-scatter. Both
functions here replace the collective by ``tp - 1`` hops to the next rank
of the tensor group, each beside a partial GEMM:

- :func:`all_gather_matmul` (``AG(x) @ w.T``): every rank starts from its
  own sequence chunk, multiplies it and passes it on; after ``tp - 1``
  hops each rank has the product of the full sequence. The gathered ``x``
  falls out of the ring and is kept for the backward.
- :func:`matmul_reduce_scatter` (``RS(x @ w.T [+ partial_add])``): a
  partial sum travels the ring; at each stop the rank adds the product of
  the sequence chunk the sum is bound for. The fixed ring order fixes the
  fp32 summation order; at tp = 2 a two-term sum is the same in either
  order, so in fp32 the result equals the fused path's bit for bit.

Each is a ``torch.autograd.Function`` whose backward is the transposed
ring, as the reference's ``_ag_mm_bwd`` and ``_mm_rs_bwd`` are::

    all_gather_matmul:     dX = RS(dY @ W) (ring), dW = dY^T @ AG(X)
    matmul_reduce_scatter: dX = AG(dY) @ W (ring), dW = AG(dY)^T @ X

Products accumulate in fp32 (the operands are widened to fp32 first, as
the port's dense layers do) and both functions return fp32; the caller
casts. The products are ``torch.mm``: the JAX package computes them
outside any Pallas kernel.

The sharded layers' sequence-parallel path without the overlap runs the
same autograd Functions with one all-gather or reduce-scatter in place
of the hops (:func:`sequence_parallel_matmul`, ``ring=False``), around
the same partial GEMMs, a sequence chunk each, and with the reference's
casts (the Row pair's partials and its ``dX``'s rounded to the
activation dtype before the reduction). The two paths then differ only
in how the chunks travel and in the order of the sums, so at tp = 2 in
fp32 they agree bit for bit on any backend. A GEMM's rows need not: under
cuBLAS a whole-sequence product and the ring's chunk products can differ
in the last bit, as the kernel is chosen by the row count.

**Transport.** A hop is one ``torch.distributed.batch_isend_irecv`` of a
send to the next rank and a receive from the previous one, through
:func:`apex_tpu_torch.parallel._p2p.exchange`, which the pipeline's stage
hops share: on NCCL the tensor is sent where it lies, and on a gloo group
a CUDA tensor is staged through host tensors (gloo has no
point-to-point path for CUDA tensors).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel._p2p import exchange
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_gather, reduce_scatter, tensor_group)

__all__ = ["all_gather_matmul", "matmul_reduce_scatter"]


class _Ring:
    """The tensor group's ring: this rank's index, the size, and the
    global ranks of its neighbours."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        ranks: List[int] = dist.get_process_group_ranks(group)
        self.next = ranks[(self.rank + 1) % self.size]
        self.prev = ranks[(self.rank - 1) % self.size]

    def hop(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to the next rank; the previous rank's ``t``."""
        return exchange([(t, self.next)], [(t, self.prev)], self.group)[0]


def _mm(a: torch.Tensor, w: torch.Tensor, w_axis: int) -> torch.Tensor:
    """``a``'s last dim contracted with ``w``'s dim ``w_axis``, in fp32:
    one ``torch.mm`` over ``a``'s rows, made contiguous first (a chunk of
    the sequence is copied), so a chunk's product is the same call on
    either path."""
    w = w.float()
    rows = a.float().reshape(-1, a.shape[-1])
    out = torch.mm(rows, w.t() if w_axis == 1 else w)
    return out.reshape(*a.shape[:-1], out.shape[-1])


def _chunk_mm(a: torch.Tensor, w: torch.Tensor, parts: int, dim: int,
              w_axis: int) -> torch.Tensor:
    """``_mm`` chunk by chunk of ``a``'s ``dim``, concatenated: the ring's
    partial GEMMs, all on this rank."""
    return torch.cat([_mm(c, w, w_axis) for c in a.chunk(parts, dim)], dim)


def _chunk(x: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    return x.narrow(dim, index * size, size)


def _ring_all_gather_matmul(x, w, ring: _Ring, dim: int, w_axis: int):
    """``(AG(x, dim) . w, AG(x, dim))``: the product in fp32 and the
    gathered operand in ``x``'s dtype, from ``tp - 1`` hops. After ``t``
    hops this rank holds the chunk of rank ``rank - t``."""
    tp, s = ring.size, x.shape[dim]
    cur, y_full, x_full = x, None, None
    for t in range(tp):
        origin = (ring.rank - t) % tp
        part = _mm(cur, w, w_axis)
        if y_full is None:
            y_shape = list(part.shape)
            y_shape[dim] = tp * s
            y_full = part.new_empty(y_shape)
            x_shape = list(cur.shape)
            x_shape[dim] = tp * s
            x_full = cur.new_empty(x_shape)
        _chunk(y_full, dim, origin, s).copy_(part)
        _chunk(x_full, dim, origin, s).copy_(cur)
        if t < tp - 1:
            cur = ring.hop(cur)
    return y_full, x_full


def _ring_matmul_reduce_scatter(x, w, ring: _Ring, dim: int, w_axis: int,
                                partial_add: Optional[torch.Tensor] = None):
    """This rank's ``dim`` shard of the rank-sum of ``x . w [+
    partial_add]``, fp32. The sum bound for chunk ``c`` starts on rank
    ``c + 1`` and visits the ranks in ring order, ending at its owner."""
    tp = ring.size
    _check_seq(x, dim, tp)
    s = x.shape[dim] // tp
    acc = None
    for t in range(tp):
        c = (ring.rank - t - 1) % tp
        part = _mm(_chunk(x, dim, c, s), w, w_axis)
        if partial_add is not None:
            part = part + partial_add.float()
        acc = part if acc is None else ring.hop(acc) + part
    return acc


def _check_seq(x: torch.Tensor, dim: int, tp: int) -> None:
    if x.shape[dim] % tp:
        raise ValueError(
            f"matmul_reduce_scatter: dim {dim} of size {x.shape[dim]} is "
            f"not divisible by the tensor group's size {tp}")


def _weight_grad(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``dy^T @ x`` over the flattened rows, fp32 ``(out, in)``."""
    return torch.mm(dy.float().reshape(-1, dy.shape[-1]).t(),
                    x.float().reshape(-1, x.shape[-1]))


class _AllGatherMatmul(torch.autograd.Function):
    """``ring``: hops beside the partial GEMMs; else one all-gather, then
    the same partial GEMMs (the layers' fused path), with the reference's
    casts: ``dX``'s partials rounded to ``x``'s dtype before the
    reduce-scatter."""

    @staticmethod
    def forward(ctx, x, w_t, group, dim, ring):
        r = _Ring(group)
        if ring:
            y, x_full = _ring_all_gather_matmul(x, w_t, r, dim, w_axis=1)
        else:
            x_full = all_gather(x, group, dim)
            y = _chunk_mm(x_full, w_t, r.size, dim, 1)
        ctx.save_for_backward(w_t, x_full)
        ctx.r, ctx.dim, ctx.ring, ctx.x_dtype = r, dim, ring, x.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        w_t, x_full = ctx.saved_tensors
        # dX: the reduce-scatter of dY @ W, on the ring each hop beside
        # the next partial GEMM; dW: one GEMM over the gathered operand
        if ctx.ring:
            dx = _ring_matmul_reduce_scatter(dy, w_t, ctx.r, ctx.dim,
                                             w_axis=0)
        else:
            dx = reduce_scatter(_chunk_mm(dy, w_t, ctx.r.size, ctx.dim, 0)
                                .to(ctx.x_dtype), ctx.r.group, ctx.dim)
        dw = _weight_grad(dy, x_full)
        return dx.to(ctx.x_dtype), dw.to(w_t.dtype), None, None, None


class _MatmulReduceScatter(torch.autograd.Function):
    """``ring``: a partial sum travelling the ring, fp32; else the same
    partial GEMMs rounded to ``x``'s dtype, ``partial_add`` added in that
    dtype, and one reduce-scatter (the layers' fused path, in the
    reference's order)."""

    @staticmethod
    def forward(ctx, x, w_t, partial_add, group, dim, ring):
        r = _Ring(group)
        if ring:
            y = _ring_matmul_reduce_scatter(x, w_t, r, dim, w_axis=1,
                                            partial_add=partial_add)
        else:
            _check_seq(x, dim, r.size)
            parts = _chunk_mm(x, w_t, r.size, dim, 1).to(x.dtype)
            if partial_add is not None:
                parts = parts + partial_add.to(parts.dtype)
            y = reduce_scatter(parts, group, dim)
        ctx.save_for_backward(x, w_t)
        ctx.r, ctx.dim, ctx.ring = r, dim, ring
        ctx.add_shape = (None if partial_add is None
                         else tuple(partial_add.shape))
        ctx.add_dtype = None if partial_add is None else partial_add.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w_t = ctx.saved_tensors
        # dX: AG(dY) @ W; on the ring the gathered dY falls out of it
        if ctx.ring:
            dx, dy_full = _ring_all_gather_matmul(dy, w_t, ctx.r, ctx.dim,
                                                  w_axis=0)
        else:
            dy_full = all_gather(dy, ctx.r.group, ctx.dim)
            dx = _chunk_mm(dy_full, w_t, ctx.r.size, ctx.dim, 0)
        dw = _weight_grad(dy_full, x)
        d_add = None
        if ctx.add_shape is not None:
            # every rank's partial carried partial_add at every position,
            # so its gradient is the broadcast-transpose of dY_full, the
            # same on every rank: sum every axis it was broadcast along
            # (in dY's dtype on the fused path, as autograd sums it there)
            shape = ctx.add_shape
            padded = (1,) * (dy_full.dim() - len(shape)) + shape
            axes = tuple(i for i, n in enumerate(padded) if n == 1)
            g = dy_full.float() if ctx.ring else dy_full
            d_add = g.sum(dim=axes).reshape(shape).to(ctx.add_dtype)
        return (dx.to(x.dtype), dw.to(w_t.dtype), d_add, None, None,
                None)


def all_gather_matmul(x: torch.Tensor, w_t: torch.Tensor,
                      axis_name=TENSOR_AXIS,
                      seq_axis: int = 1) -> torch.Tensor:
    """``all_gather(x, seq_axis) @ w_t.T`` with the gather cut into ring
    hops beside the partial GEMMs: the sequence-parallel ColumnParallel
    forward. ``x``: this rank's ``(..., s_local, ..., in)`` sequence
    shard; ``w_t``: the ``(out, in)`` weight shard. Returns the
    ``(..., tp * s_local, ..., out)`` product in fp32."""
    return _AllGatherMatmul.apply(x, w_t, tensor_group(axis_name),
                                  seq_axis % x.dim(), True)


def matmul_reduce_scatter(x: torch.Tensor, w_t: torch.Tensor,
                          partial_add: Optional[torch.Tensor] = None,
                          axis_name=TENSOR_AXIS,
                          seq_axis: int = 1) -> torch.Tensor:
    """``reduce_scatter(x @ w_t.T [+ partial_add], seq_axis)`` with the
    reduction cut into ring hops beside the partial GEMMs: the
    sequence-parallel RowParallel forward. ``x``: the full-sequence
    ``(..., s, ..., in_local)`` operand; ``w_t``: the ``(out, in_local)``
    shard; ``partial_add``: a term broadcast onto every rank's partial
    before the sum (the RowParallel bias fold), whose gradient is the
    full-sequence sum on every rank. Returns this rank's ``(..., s / tp,
    ..., out)`` shard in fp32; a sequence the group does not divide
    raises ``ValueError``."""
    return _MatmulReduceScatter.apply(x, w_t, partial_add,
                                      tensor_group(axis_name),
                                      seq_axis % x.dim(), True)


def sequence_parallel_matmul(x: torch.Tensor, w_t: torch.Tensor,
                             seq_axis: int, column: bool, ring: bool,
                             partial_add: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The sharded layers' sequence-parallel GEMM over the tensor group:
    ``column`` the gather -> GEMM pair (:func:`all_gather_matmul`), else
    the GEMM -> reduce-scatter pair (:func:`matmul_reduce_scatter`, with
    ``partial_add``); ``ring`` the ring-decomposed form (fp32 out), else
    one collective around the same partial GEMMs (the Row pair's out in
    ``x``'s dtype)."""
    group, dim = tensor_group(TENSOR_AXIS), seq_axis % x.dim()
    if column:
        return _AllGatherMatmul.apply(x, w_t, group, dim, ring)
    return _MatmulReduceScatter.apply(x, w_t, partial_add, group, dim,
                                      ring)
