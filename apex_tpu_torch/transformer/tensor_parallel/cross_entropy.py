"""Vocab-parallel cross-entropy at tp=1, the counterpart of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``.

Reference: ``reference:apex/transformer/tensor_parallel/
cross_entropy.py:23-99``: the max over the vocab, the predicted logit and
the sum of exponents, each reduced over the tensor-parallel ranks, then
``loss = log(sum_exp) - predicted``. At one rank each reduction is the
identity. The math is fp32, the max shift is detached (it cancels in the
gradient), and the backward is autograd's, as the JAX package's is AD's.
A world size above 1 raises: the sharded form comes with tensor
parallelism (queue item A5b).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.transformer.tensor_parallel.layers import _require_tp1

__all__ = ["vocab_parallel_cross_entropy"]


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 world_size: int = 1) -> torch.Tensor:
    """fp32 per-token loss from logits ``(..., vocab)``; with
    ``label_smoothing`` ``s``, ``(1 - s) * nll + s * (log_sum_exp -
    mean(logits))`` (the reference's smoothing branch)."""
    _require_tp1(world_size)
    logits = vocab_parallel_logits.float()
    shifted = logits - logits.max(dim=-1, keepdim=True).values.detach()
    sum_exp = torch.exp(shifted).sum(dim=-1)
    predicted = torch.gather(shifted, -1, target.long().unsqueeze(-1))[..., 0]
    log_sum = torch.log(sum_exp)
    loss = log_sum - predicted
    if label_smoothing > 0.0:
        mean_logits = shifted.sum(dim=-1) / shifted.shape[-1]
        loss = (1.0 - label_smoothing) * loss + label_smoothing * (
            log_sum - mean_logits)
    return loss
