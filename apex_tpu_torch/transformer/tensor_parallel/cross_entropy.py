"""Vocab-parallel cross-entropy, the counterpart of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``.

Reference: ``reference:apex/transformer/tensor_parallel/
cross_entropy.py:23-99``. The logits are sharded along the vocab, rank
``r`` holding ``[r * V/tp, (r + 1) * V/tp)``: the local maxima are
all-reduced with MAX (detached: the shift cancels in the gradient), the
sums of exponents and the owning rank's target logit with SUM, and
``loss = log(sum_exp) - predicted``. The math is fp32. The SUMs are
:func:`~.mappings.reduce_from_tensor_model_parallel_region` (identity
backward), so autograd's backward is the reference's: ``softmax -
onehot`` on each rank's shard, with the one-hot only on the owning rank.

The tensor group is the installed mesh's (``world_size`` defaults to its
size, 1 without a mesh, where every reduction is the identity; a size
above 1 must be the group's).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer.tensor_parallel.layers import (
    tensor_rank, tensor_world_size)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_reduce, reduce_from_tensor_model_parallel_region, tensor_group)

__all__ = ["vocab_parallel_cross_entropy"]


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 world_size: Optional[int] = None
                                 ) -> torch.Tensor:
    """fp32 per-token loss from this rank's logits ``(..., vocab / tp)``
    and the global ``target`` ids; with ``label_smoothing`` ``s``, ``(1 -
    s) * nll + s * (log_sum_exp - mean(logits))`` (the reference's
    smoothing branch, the mean over the whole vocab)."""
    tp = tensor_world_size(world_size)
    logits = vocab_parallel_logits.float()
    local_max = logits.max(dim=-1, keepdim=True).values.detach()
    if tp > 1:
        local_max = all_reduce(local_max, tensor_group(),
                               op=dist.ReduceOp.MAX)
    shifted = logits - local_max
    sum_exp = torch.exp(shifted).sum(dim=-1)
    target = target.long()
    if tp == 1:
        predicted = torch.gather(shifted, -1, target.unsqueeze(-1))[..., 0]
    else:
        # only the owning rank contributes the target's logit (:40-52)
        vp = shifted.shape[-1]
        start = tensor_rank(tp) * vp
        in_range = (target >= start) & (target < start + vp)
        local = torch.where(in_range, target - start, 0)
        picked = torch.gather(shifted, -1, local.unsqueeze(-1))[..., 0]
        predicted = reduce_from_tensor_model_parallel_region(
            torch.where(in_range, picked, 0.0))
        sum_exp = reduce_from_tensor_model_parallel_region(sum_exp)
    log_sum = torch.log(sum_exp)
    loss = log_sum - predicted
    if label_smoothing > 0.0:
        total = shifted.sum(dim=-1)
        if tp > 1:
            total = reduce_from_tensor_model_parallel_region(total)
        mean_logits = total / (shifted.shape[-1] * tp)
        loss = (1.0 - label_smoothing) * loss + label_smoothing * (
            log_sum - mean_logits)
    return loss
