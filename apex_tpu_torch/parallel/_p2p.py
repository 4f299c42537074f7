"""Point-to-point exchanges on any backend.

One function, :func:`exchange`, posts a rank's sends and receives as one
``torch.distributed.batch_isend_irecv`` batch and waits for all of them.
The ring collective matmuls (``transformer/tensor_parallel/
collective_matmul.py``) and the pipeline's stage hops
(``transformer/pipeline_parallel/p2p_communication.py``) both call it.

On NCCL a tensor is sent where it lies. Gloo has no point-to-point path
for CUDA tensors: its send and receive hand the device pointer to the
socket, and the process dies (``writev ... Bad address``, torch
2.11.0+cu128 on an H100). So on a gloo group a CUDA tensor is staged
through host tensors: copied to the host, sent, received into a host
tensor and copied back. The choice is made by the group's backend,
before any send; a copy to the host and back is exact.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["exchange"]


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
        send = t.to("cpu") if staged and t.is_cuda else t.contiguous()
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
