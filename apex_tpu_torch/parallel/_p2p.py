"""Point-to-point exchanges and the tiled all-to-all, on any backend.

:func:`exchange` posts a rank's sends and receives as one
``torch.distributed.batch_isend_irecv`` batch and waits for all of them.
The ring collective matmuls (``transformer/tensor_parallel/
collective_matmul.py``) and the pipeline's stage hops
(``transformer/pipeline_parallel/p2p_communication.py``) call it;
:func:`rotate`, a differentiable hop of a group's ring built on it, moves
ring attention's k/v chunks (``transformer/context_parallel.py``) and the
halo rows of the spatial convolution (``parallel/spatial.py``).
:func:`all_to_all` is the reference's tiled ``lax.all_to_all``, with the
inverse exchange as its backward: Ulysses attention and the
expert-parallel MoE run on it.

On NCCL a tensor is sent where it lies. Gloo has no point-to-point path
for CUDA tensors: its send and receive hand the device pointer to the
socket, and the process dies (``writev ... Bad address``, torch
2.11.0+cu128 on an H100). So on a gloo group a CUDA tensor is staged
through host tensors: copied to the host, sent, received into a host
tensor and copied back. The choice is made by the group's backend,
before any send; a copy to the host and back is exact. The all-to-all
does the same on gloo: whether gloo's all-to-all takes CUDA tensors is
not relied on.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["exchange", "rotate", "all_to_all"]


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]],
             group) -> List[torch.Tensor]:
    """Send each ``(tensor, peer)`` of ``sends`` and receive one tensor
    shaped, typed and placed like ``like`` from each ``(like, peer)`` of
    ``recvs``, as one batch on ``group`` (peers are global ranks); returns
    the received tensors in the order of ``recvs``. Two ranks that
    exchange post their operations on each other in the same order."""
    staged = dist.get_backend(group) == "gloo"
    ops, bufs = [], []
    for t, peer in sends:
        t = t.detach()
        send = (t.to("cpu") if staged and t.is_cuda else t).contiguous()
        ops.append(dist.P2POp(dist.isend, send, peer, group))
    for like, peer in recvs:
        host = staged and like.is_cuda
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if host else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
        bufs.append((buf, like.device if host else None))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [buf if dev is None else buf.to(dev) for buf, dev in bufs]


def _hop(xs: Sequence[torch.Tensor], group, step: int
         ) -> Tuple[torch.Tensor, ...]:
    ranks = dist.get_process_group_ranks(group)
    size, me = len(ranks), dist.get_rank(group)
    if size == 1:
        return tuple(x.detach().clone() for x in xs)
    dst, src = ranks[(me + step) % size], ranks[(me - step) % size]
    return tuple(exchange([(x, dst) for x in xs], [(x, src) for x in xs],
                          group))


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, step, *xs):
        ctx.group, ctx.step = group, step
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return _hop(xs, group, step)

    @staticmethod
    def backward(ctx, *gs):
        # every rank posts the same hops: a gradient autograd left out
        # travels as zeros
        gs = [torch.zeros(s, dtype=t, device=d) if g is None else g
              for g, (s, t, d) in zip(gs, ctx.like)]
        return (None, None) + _hop(gs, ctx.group, -ctx.step)


def rotate(xs: Sequence[torch.Tensor], group, step: int = 1
           ) -> Tuple[torch.Tensor, ...]:
    """Every rank of ``group`` sends each tensor of ``xs`` to the rank
    ``step`` places after it (wrapping) and receives the one ``step``
    places before: one :func:`exchange` batch, differentiable (the
    backward is the rotation by ``-step``, the transpose of the
    reference's ``ppermute``). A group of one rank returns copies."""
    return _Rotate.apply(group, step, *xs)


def _all_to_all(x: torch.Tensor, group, split: int, concat: int
                ) -> torch.Tensor:
    world = dist.get_world_size(group)
    if x.shape[split] % world:
        raise ValueError(f"all_to_all: dim {split} of size {x.shape[split]} "
                         f"does not split into {world} parts")
    if world == 1:
        return x.detach().clone()
    send = torch.stack(x.chunk(world, split))   # part j goes to rank j
    staged = dist.get_backend(group) == "gloo" and send.is_cuda
    if staged:
        send = send.to("cpu")
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.concat, ctx.split), None, \
            None, None


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` is cut into ``world`` parts along ``split_axis``, part ``j``
    goes to rank ``j`` of ``group``, and the parts received are
    concatenated along ``concat_axis`` in rank order. Differentiable: the
    backward is the all-to-all with the two axes swapped."""
    return _AllToAll.apply(x, group, split_axis % x.dim(),
                           concat_axis % x.dim())
