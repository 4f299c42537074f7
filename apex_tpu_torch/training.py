"""Training-loop helpers across ranks.

Counterpart of ``apex_tpu/training.py``, whose :func:`accumulate_gradients`
it ports: gradient accumulation with one data-parallel sync a window.
The reference's ``GPTHybridTrainer`` (a tp x pp x dp trainer) comes with
pipelines (queue item A5c), and ``resolve_bucket_bytes`` with pyprof's
roofline tuner (A7b).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

__all__ = ["accumulate_gradients"]


def accumulate_gradients(ddp, loss_fn: Callable, params: Any,
                         microbatches: Any) -> Tuple[torch.Tensor, Any]:
    """``(mean loss, synced grads)`` over a window of microbatches, with
    one :meth:`ddp.sync_gradients
    <apex_tpu_torch.parallel.DistributedDataParallel.sync_gradients>` a
    window (``DistributedDataParallel(delay_allreduce=True)``'s use).

    ``loss_fn(params, microbatch) -> scalar``; ``params`` a tree of leaf
    tensors that require grad; ``microbatches`` a tree of tensors with a
    leading window axis ``K``. Each microbatch's grads
    (``torch.autograd.grad``, unsynced) are summed in order into zeros,
    divided by ``K`` and synced once, as the reference's scan does; the
    loss is this rank's window mean. An empty window (``K == 0``), leaves
    that disagree on ``K``, or a ``ddp.axis_name`` that is not bound
    raise ``ValueError`` before any work.
    """
    from apex_tpu_torch.transformer.parallel_state import resolve_axis

    leading = {leaf.shape[0] for leaf in tree_leaves(microbatches)}
    if len(leading) != 1:
        raise ValueError(
            f"microbatch leaves disagree on the accumulation axis: "
            f"{sorted(leading)}")
    num_micro = leading.pop()
    if num_micro == 0:
        raise ValueError(
            "accumulate_gradients got an empty accumulation window "
            "(num_micro == 0); every microbatch leaf has leading dim 0")
    try:
        resolve_axis(ddp.axis_name)
    except ValueError as e:
        raise ValueError(
            f"accumulate_gradients must run where ddp.axis_name="
            f"{ddp.axis_name!r} is bound; it is not bound here: {e}") from e

    leaves, spec = tree_flatten(params)
    acc = [torch.zeros_like(p, memory_format=torch.contiguous_format)
           for p in leaves]
    loss_sum = None
    for k in range(num_micro):
        mb = tree_map(lambda x: x[k], microbatches)
        loss = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        acc = [a + g for a, g in zip(acc, grads)]
        loss = loss.detach().to(torch.float32)
        loss_sum = loss if loss_sum is None else loss_sum + loss
    mean_grads = spec.unflatten([a / num_micro for a in acc])
    return loss_sum / num_micro, ddp.sync_gradients(mean_grads)
