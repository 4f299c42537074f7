"""Sigmoid focal loss (detection), the counterpart of
``apex_tpu/ops/focal_loss.py``.

Reference: ``reference:apex/contrib/focal_loss/focal_loss.py`` over
``focal_loss_cuda_kernel.cu:30-110``. Target code per anchor: ``-2``
ignores the anchor (zero loss and grad), ``-1`` makes every class a
negative, ``y >= 0`` makes class ``y`` the positive and the rest
negatives. With ``sigma = sigmoid(x)`` and ``softplus(-x) = log(1 +
exp(-x))``:

  negative: ``(1-alpha) * sigma**gamma     * (nn*x + softplus(-x))``
  positive: ``alpha     * (1-sigma)**gamma * (pn*x + softplus(-x))``

with ``nn = 1, pn = 0`` without smoothing and ``nn = 1 - s/K, pn = s -
s/K`` under label smoothing ``s``. The sum is divided by
``num_positives_sum``; columns ``>= num_real_classes`` (padding) are
skipped. All math is fp32 and the backward is autograd's, as the
reference's is JAX's AD. The JAX package leaves the op to XLA (no Pallas
kernel), so the port runs it as torch ops: one elementwise chain and a
sum.
"""

from __future__ import annotations

import torch

__all__ = ["focal_loss", "FocalLoss"]


def focal_loss(cls_output: torch.Tensor, cls_targets: torch.Tensor,
               num_positives_sum: torch.Tensor, num_real_classes: int,
               alpha: float, gamma: float,
               label_smoothing: float = 0.0) -> torch.Tensor:
    """fp32 scalar total loss. ``cls_output``: ``(..., K)`` logits;
    ``cls_targets``: ``(...,)`` int labels in {-2, -1, 0..K-1}."""
    x = cls_output.float()
    k = x.shape[-1]
    y = cls_targets.unsqueeze(-1)
    if label_smoothing > 0.0:
        s = label_smoothing
        nn, pn = 1.0 - s / k, s - s / k
    else:
        nn, pn = 1.0, 0.0

    col = torch.arange(k, device=x.device)
    is_pos = (y >= 0) & (col == y)
    valid = (y != -2) & (col < num_real_classes)

    sigma = torch.sigmoid(x)
    off_a = torch.logaddexp(-x, x.new_zeros(()))
    loss_neg = (1.0 - alpha) * torch.pow(sigma, gamma) * (nn * x + off_a)
    loss_pos = alpha * torch.pow(1.0 - sigma, gamma) * (pn * x + off_a)
    elem = torch.where(is_pos, loss_pos, loss_neg)
    elem = torch.where(valid, elem, x.new_zeros(()))
    denom = torch.as_tensor(num_positives_sum, device=x.device)
    return elem.sum() / denom.float().reshape(())


class FocalLoss:
    """``FocalLoss.apply(...)``: :func:`focal_loss` under the reference's
    autograd-function name."""

    @staticmethod
    def apply(cls_output, cls_targets_at_level, num_positives_sum,
              num_real_classes, alpha, gamma, label_smoothing=0.0):
        return focal_loss(cls_output, cls_targets_at_level,
                          num_positives_sum, num_real_classes, alpha, gamma,
                          label_smoothing)
