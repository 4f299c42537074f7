"""Stage-to-stage exchange of activations and grads: the stage hops.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/
p2p_communication.py``. The reference rotates a tensor over the ``pipe``
axis (``ppermute``): every stage sends to the next one and receives from
the previous one (wrapping), or the other way round, and its eight
upstream names collapse to those two rotations. Here a hop is a send to
the next (or previous) rank of this rank's pipeline group and a receive
from the other, posted as one ``batch_isend_irecv`` batch through
:func:`apex_tpu_torch.parallel._p2p.exchange`, which stages CUDA tensors
through host tensors on a gloo group. :func:`rotate_forward` and
:func:`rotate_backward` are :func:`apex_tpu_torch.parallel._p2p.rotate`
over the pipe group, whose backward is the reverse rotation (the
transpose of the reference's ``ppermute``).

The schedules post their hops through :func:`exchange_stages`, which
takes pipeline ranks and skips an empty batch. Two ranks post their
operations on each other in the same order, so a hop never waits on
one the other rank has not posted. A hop whose peer never posts hangs
until a limit ends it: the process group's timeout, or the limit a
:class:`~apex_tpu_torch.parallel._spawn.RankPool` puts on every call.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel._p2p import exchange, rotate
from apex_tpu_torch.transformer.parallel_state import PIPE_AXIS, resolve_axis

__all__ = [
    "rotate_forward", "rotate_backward",
    "send_forward_recv_forward", "send_backward_recv_backward",
]


class _Pipe:
    """This rank's pipeline group: its size, index and members."""

    def __init__(self):
        self.group = resolve_axis(PIPE_AXIS)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ranks: List[int] = dist.get_process_group_ranks(self.group)


def exchange_stages(pipe: _Pipe,
                    sends: Sequence[Tuple[torch.Tensor, int]],
                    recvs: Sequence[Tuple[torch.Tensor, int]]
                    ) -> List[torch.Tensor]:
    """:func:`~apex_tpu_torch.parallel._p2p.exchange` with peers given as
    pipeline ranks; nothing is posted when both lists are empty."""
    if not sends and not recvs:
        return []
    return exchange([(t, pipe.ranks[p]) for t, p in sends],
                    [(like, pipe.ranks[p]) for like, p in recvs],
                    pipe.group)


def _rotate(x: torch.Tensor, step: int) -> torch.Tensor:
    return rotate((x,), resolve_axis(PIPE_AXIS), step)[0]


def rotate_forward(x: torch.Tensor) -> torch.Tensor:
    """Every stage sends ``x`` to the next stage and receives the previous
    stage's (wrapping: stage 0 receives the last stage's):
    ``send_forward`` and ``recv_forward`` of the reference."""
    return _rotate(x, 1)


def rotate_backward(g: torch.Tensor) -> torch.Tensor:
    """``send_backward`` and ``recv_backward``: ``g`` goes to the previous
    stage, the next stage's comes in."""
    return _rotate(g, -1)


# the reference's upstream names
send_forward_recv_forward = rotate_forward
send_backward_recv_backward = rotate_backward
