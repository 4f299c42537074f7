"""Softmax cross-entropy with label smoothing for the port.

Counterpart of ``apex_tpu/ops/xentropy.py`` (``softmax_cross_entropy_loss``):
an ``autograd.Function`` that saves only the logits and the per-row
``max_log_sum_exp``, not the softmax, and recomputes the probabilities in
the backward. Loss with smoothing ``s``: ``logsumexp - (1 - s) *
logit[label] - s * mean(logits)``; grad ``softmax - ((1 - s) * onehot + s /
classes)``; both zeroed where ``label == padding_idx``. The default
``padding_idx`` is 0, as in the reference; GPT passes ``None``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["softmax_cross_entropy_loss"]


class _SoftmaxXentropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, smoothing: float,
                padding_idx: Optional[int]):
        lf = logits.float()
        m = lf.amax(dim=-1, keepdim=True)
        sumexp = torch.exp(lf - m).sum(dim=-1)
        mlse = m[..., 0] + torch.log(sumexp)   # the saved scalar per row
        picked = lf.gather(-1, labels[..., None])[..., 0]
        if smoothing == 0.0:
            losses = mlse - picked
        else:
            losses = (mlse - (1.0 - smoothing) * picked
                      - smoothing * lf.mean(dim=-1))
        if padding_idx is not None:
            losses = torch.where(labels == padding_idx, 0.0, losses)
        ctx.save_for_backward(logits, labels, mlse)
        ctx.smoothing = smoothing
        ctx.padding_idx = padding_idx
        return losses

    @staticmethod
    def backward(ctx, g):
        logits, labels, mlse = ctx.saved_tensors
        smoothing = ctx.smoothing
        probs = torch.exp(logits.float() - mlse[..., None])  # recomputed
        n_classes = logits.shape[-1]
        target = torch.full_like(probs, smoothing / n_classes)
        target.scatter_add_(-1, labels[..., None], torch.full_like(
            probs[..., :1], 1.0 - smoothing))
        if ctx.padding_idx is not None:
            g = torch.where(labels == ctx.padding_idx, 0.0, g)
        grad = (probs - target) * g[..., None]
        return grad.to(logits.dtype), None, None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0,
                               padding_idx: Optional[int] = 0,
                               half_to_float: bool = False) -> torch.Tensor:
    """Per-row losses, shape ``labels.shape``: fp32 with ``half_to_float``,
    else in the logits' dtype (fp32 internally either way)."""
    losses = _SoftmaxXentropy.apply(logits, labels.long(), float(smoothing),
                                    padding_idx)
    return losses if half_to_float else losses.to(logits.dtype)
