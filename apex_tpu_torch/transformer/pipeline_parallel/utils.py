"""Pipeline-parallel utilities.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/utils.py``: the
process-global microbatch calculator, microbatch slicing, the loss
average over the data group, a memory report, the left-to-right masks
and position ids, and the parameters' L2 norm over the model-parallel
groups. The reductions run over the process groups that mesh axis names
give (:func:`~apex_tpu_torch.transformer.parallel_state.resolve_axis`),
where the reference reduces over a ``shard_map`` axis.

A parameter tree here is a tree (dicts, lists, tuples) of tensors and
``nn.Module``\\ s; a module stands for its ``named_parameters()`` as a
dict (:func:`param_tree`), which is how the schedules return its grads.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_leaves, tree_map

from apex_tpu_torch.transformer.parallel_state import DATA_AXIS, resolve_axis
from apex_tpu_torch.transformer.pipeline_parallel.microbatches import (
    build_num_microbatches_calculator)

__all__ = [
    "setup_microbatch_calculator", "get_num_microbatches",
    "get_current_global_batch_size", "update_num_microbatches",
    "get_micro_batch_size", "get_kth_microbatch", "listify_model",
    "average_losses_across_data_parallel_group", "report_memory",
    "get_ltor_masks_and_position_ids", "calc_params_l2_norm",
    "unwrap_model",
]

_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def param_tree(tree: Any) -> Any:
    """``tree`` with each ``nn.Module`` replaced by the dict of its
    ``named_parameters()``: the tree of tensors its grads come back in."""
    return tree_map(lambda m: dict(m.named_parameters())
                    if isinstance(m, nn.Module) else m, tree,
                    is_leaf=lambda x: isinstance(x, nn.Module))


def setup_microbatch_calculator(rank: int,
                                rampup_batch_size: Optional[List[int]],
                                global_batch_size: int, micro_batch_size: int,
                                data_parallel_size: int) -> None:
    """Install the process-global calculator, once."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is not None:
        raise RuntimeError(
            "num microbatches calculator is already initialized.")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)


def _calc():
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is None:
        raise RuntimeError("microbatch calculator is not initialized")
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR


def get_num_microbatches() -> int:
    return _calc().get()


def get_current_global_batch_size() -> int:
    return _calc().get_current_global_batch_size()


def get_micro_batch_size() -> int:
    return _calc().micro_batch_size


def update_num_microbatches(consumed_samples: int,
                            consistency_check: bool = True) -> None:
    _calc().update(consumed_samples, consistency_check)


def destroy_microbatch_calculator() -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def get_kth_microbatch(batch: Any, k: int) -> Any:
    """Microbatch ``k`` of leaves shaped ``(num_micro * micro_bs, ...)``:
    rows ``[k * micro_bs, (k + 1) * micro_bs)`` of each (views)."""
    mbs = get_micro_batch_size()
    return tree_map(lambda x: x[k * mbs:(k + 1) * mbs], batch)


def listify_model(model: Any) -> List[Any]:
    return model if isinstance(model, list) else [model]


def unwrap_model(model, module_instances=()):
    """The model itself: no wrapper modules exist here (API parity)."""
    return model


def average_losses_across_data_parallel_group(
        losses: Sequence[torch.Tensor]) -> torch.Tensor:
    """The losses stacked in fp32 and averaged over the data group: a
    sum over the group, then a division by its size."""
    group = resolve_axis(DATA_AXIS)
    stacked = torch.stack([torch.as_tensor(x).to(torch.float32)
                           for x in losses])
    dist.all_reduce(stacked, group=group)
    return stacked / dist.get_world_size(group)


def report_memory(name: str) -> str:
    """Each local card's allocated and peak memory in MB, printed and
    returned. Without a card the report says the stats are absent."""
    lines = [f"[{name}] memory (MB)"]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            used = torch.cuda.memory_allocated(i) / 2 ** 20
            peak = torch.cuda.max_memory_allocated(i) / 2 ** 20
            lines.append(f"  cuda:{i}: in_use {used:.1f} | peak {peak:.1f}")
    else:
        lines.append("  cpu: memory_stats unavailable")
    report = "\n".join(lines)
    print(report, flush=True)
    return report


def get_ltor_masks_and_position_ids(
    data: torch.Tensor,
    eod_token: int,
    reset_position_ids: bool = False,
    reset_attention_mask: bool = False,
    eod_mask_loss: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal mask, loss mask and position ids for a ``(b, s)`` batch.

    Returns ``attention_mask (b, 1, s, s)`` bool (True = masked),
    ``loss_mask (b, s)`` fp32 (0 at EOD tokens with ``eod_mask_loss``)
    and ``position_ids (b, s)`` int32. A token's document is the count of
    EOD tokens strictly before it (an EOD belongs to the document it
    ends): ``reset_attention_mask`` keeps attention inside a document,
    ``reset_position_ids`` counts positions from each document's start.
    """
    b, s = data.shape
    dev = data.device
    idx = torch.arange(s, dtype=torch.int32, device=dev)
    keep = (idx[None, :] <= idx[:, None]).expand(b, s, s)

    loss_mask = torch.ones((b, s), dtype=torch.float32, device=dev)
    if eod_mask_loss:
        loss_mask = torch.where(data == eod_token, 0.0, loss_mask)

    position_ids = idx.expand(b, s)

    if reset_position_ids or reset_attention_mask:
        is_eod = (data == eod_token).to(torch.int32)
        doc_id = torch.cumsum(is_eod, dim=1) - is_eod
        same_doc = doc_id[:, :, None] == doc_id[:, None, :]
        if reset_attention_mask:
            keep = keep & same_doc
        if reset_position_ids:
            # each position's document starts at the first index of its id
            doc_start = torch.where(same_doc, idx[None, None, :],
                                    s).amin(dim=2)
            position_ids = (idx[None, :] - doc_start).to(torch.int32)

    attention_mask = ~keep[:, None, :, :]
    return attention_mask, loss_mask, position_ids.contiguous()


def calc_params_l2_norm(params: Any,
                        axis_names: Sequence[str] = ("tensor",)
                        ) -> torch.Tensor:
    """The L2 norm of every parameter across the model-parallel shards:
    this rank's fp32 sum of squares, summed over the groups of
    ``axis_names``, then the square root. Parameters are held sharded,
    so every element counts once."""
    sq = 0
    for p in tree_leaves(param_tree(params)):
        sq = sq + torch.sum(p.detach().to(torch.float32) ** 2)
    sq = torch.as_tensor(sq, dtype=torch.float32)
    for ax in axis_names:
        dist.all_reduce(sq, group=resolve_axis(ax))
    return torch.sqrt(sq)
