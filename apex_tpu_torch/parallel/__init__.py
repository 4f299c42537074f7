"""Data-parallel layer of the port (``apex_tpu/parallel/__init__.py``).

- :class:`DistributedDataParallel`, :class:`Reducer`,
  :func:`allreduce_grads`: the grad sum over a process group with apex
  DDP's numeric options and the bucketed engine;
- :class:`SyncBatchNorm` / :func:`sync_batch_norm`: batch normalization
  whose statistics are summed across ranks;
- :func:`convert_syncbn_model`: local BN to synced BN through a module
  tree; :func:`create_syncbn_process_group`: BN groups of a size, as
  ``axis_index_groups``;
- the ``LARC`` re-export (it lives with the optimizers);
- :func:`halo_exchange` and :func:`spatial_conv2d`, the height-sharded
  SAME convolution of :mod:`apex_tpu_torch.parallel.spatial`, imported
  here and left out of ``__all__``, as the reference does.
"""

from typing import List, Optional

from torch import nn

from apex_tpu_torch.optimizers.larc import LARC  # noqa: F401
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel, Reducer, allreduce_grads)
from apex_tpu_torch.parallel.spatial import (  # noqa: F401
    halo_exchange, spatial_conv2d)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    BatchNormState, SyncBatchNorm, sync_batch_norm)

__all__ = [
    "DistributedDataParallel", "Reducer", "allreduce_grads",
    "SyncBatchNorm", "BatchNormState", "sync_batch_norm",
    "convert_syncbn_model", "create_syncbn_process_group", "LARC",
]


def _synced(bn: SyncBatchNorm, axis_name, axis_index_groups
            ) -> SyncBatchNorm:
    """A synced twin of a local ``bn`` holding the same parameter and
    buffer tensors (an optimizer over them keeps working)."""
    twin = SyncBatchNorm(
        bn.num_features, eps=bn.eps, momentum=bn.momentum,
        affine=bn.affine, track_running_stats=bn.track_running_stats,
        axis_name=axis_name, axis_index_groups=axis_index_groups,
        channel_axis=bn.channel_axis, fuse_relu=bn.fuse_relu,
        param_dtype=bn.param_dtype, apply_dtype=bn.apply_dtype,
        device=bn.running_mean.device)
    twin.weight, twin.bias = bn.weight, bn.bias
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        setattr(twin, name, getattr(bn, name))
    twin.train(bn.training)
    return twin


def convert_syncbn_model(module, axis_name="data", axis_index_groups=None):
    """Every :class:`SyncBatchNorm` without an axis (plain local BN) in
    ``module`` replaced by one synced over ``axis_name``, sharing its
    parameters and buffers; one with an axis is kept as it is. Walks
    ``nn.Module`` children (in place, returning ``module``) and plain
    lists, tuples and dicts (rebuilt); anything else passes through."""
    if isinstance(module, SyncBatchNorm):
        if module.axis_name is not None:
            return module
        return _synced(module, axis_name, axis_index_groups)
    if isinstance(module, nn.Module):
        for name, child in list(module.named_children()):
            new = convert_syncbn_model(child, axis_name, axis_index_groups)
            if new is not child:
                setattr(module, name, new)
        return module
    if isinstance(module, (list, tuple)):
        return type(module)(
            convert_syncbn_model(m, axis_name, axis_index_groups)
            for m in module)
    if isinstance(module, dict):
        return {k: convert_syncbn_model(v, axis_name, axis_index_groups)
                for k, v in module.items()}
    return module


def create_syncbn_process_group(group_size: int,
                                world_size: Optional[int] = None
                                ) -> List[List[int]]:
    """``world_size`` ranks (default the initialized world's, else 1) cut
    into BN groups of ``group_size``, as ``axis_index_groups``;
    ``group_size=0`` is one group of all."""
    if world_size is None:
        import torch.distributed as dist
        world_size = (dist.get_world_size()
                      if dist.is_available() and dist.is_initialized() else 1)
    if group_size == 0:
        return [list(range(world_size))]
    if world_size % group_size != 0:
        raise ValueError(
            f"world_size {world_size} not divisible by group_size {group_size}")
    return [list(range(i, i + group_size))
            for i in range(0, world_size, group_size)]
