"""Batch broadcast across the tensor-parallel group.

Counterpart of ``apex_tpu/transformer/tensor_parallel/data.py``.
Reference: ``reference:apex/transformer/tensor_parallel/data.py``
(``broadcast_data``, :80+): every rank of a tensor group consumes the
batch of the group's first rank. Here each tensor is one
``torch.distributed.broadcast`` from the tensor group's first global
rank, in place on a copy; every rank passes tensors of the same shape
and dtype (the reference sends the sizes first; the JAX package, like
this port, takes them as given). ``datatype`` casts first, as the
reference's ``_check_data_types`` requires one type; a bool tensor
travels as int32 and comes back bool, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer.tensor_parallel.mappings import tensor_group

__all__ = ["broadcast_data", "broadcast_from_tensor_parallel_rank0"]


def broadcast_from_tensor_parallel_rank0(x: torch.Tensor) -> torch.Tensor:
    """Every tensor rank gets the tensor group's rank 0's ``x`` (a new
    tensor; ``x`` is left as it was)."""
    group = tensor_group()
    out = x.contiguous().clone()
    if dist.get_world_size(group) > 1:
        src = dist.get_process_group_ranks(group)[0]
        dist.broadcast(out, src, group=group)
    return out


def broadcast_data(keys: Sequence[str], data: Dict[str, torch.Tensor],
                   datatype=None) -> Dict[str, torch.Tensor]:
    """``{key: rank 0's data[key]}`` for every key, cast to ``datatype``
    when given."""
    out = {}
    for k in keys:
        v = data[k]
        if datatype is not None:
            v = v.to(datatype)
        if v.dtype == torch.bool:
            out[k] = broadcast_from_tensor_parallel_rank0(
                v.to(torch.int32)).to(torch.bool)
        else:
            out[k] = broadcast_from_tensor_parallel_rank0(v)
    return out
