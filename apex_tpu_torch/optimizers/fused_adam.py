"""FusedAdam and FusedAdagrad for the port.

Counterpart of ``apex_tpu/optimizers/fused_adam.py``. ``FusedAdam``: Adam
with L2 regularization folded into the grad (``adam_w_mode=False``) or
decoupled AdamW decay (``adam_w_mode=True``, the default), fp32 moments
whatever the parameters' dtype, and the reference's arithmetic order::

    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    denom = sqrt(v / bc2) + eps
    update = (m / bc1) / denom  [+ wd * p]
    p = p - lr * update

(not ``torch.optim.Adam``'s, which rounds differently). ``FusedAdagrad``:
Adagrad with the decay folded into the grad (``adagrad_w_mode=False``, the
default) or decoupled (``adagrad_w_mode=True``)::

    h = h + g * g
    update = g / (sqrt(h) + eps)  [+ wd * p]
    p = p - lr * update

Both updates run as ``torch._foreach_*`` passes over the parameter list,
in fp32 whatever the parameters' dtype; the JAX package leaves the fusion
to XLA and no Pallas kernel is involved.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_structure, tree_unflatten

from apex_tpu_torch.optimizers._base import (
    OptimizerBase, bias_correction, step_zero, tree_zeros_like_f32)

__all__ = ["FusedAdam", "AdamState", "FusedAdagrad", "AdagradState"]


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 0-d, the count of applied steps
    exp_avg: Any        # m, fp32
    exp_avg_sq: Any     # v, fp32


class FusedAdam(OptimizerBase):
    """Adam/AdamW over a tree of parameters; ``amsgrad`` raises, as in the
    reference."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        self.lr = lr
        self.use_bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay

    def init(self, params: Any) -> AdamState:
        return AdamState(
            step=step_zero(params),
            exp_avg=tree_zeros_like_f32(params),
            exp_avg_sq=tree_zeros_like_f32(params))

    def _step(self, grads: Any, state: AdamState, params: Any,
              lr: Optional[Any] = None,
              weight_decay: Optional[Any] = None) -> Tuple[Any, AdamState]:
        dev = state.step.device
        lr = torch.as_tensor(self.lr if lr is None else lr,
                             dtype=torch.float32, device=dev)
        wd = torch.as_tensor(
            self.weight_decay if weight_decay is None else weight_decay,
            dtype=torch.float32, device=dev)
        t = state.step + 1
        if self.use_bias_correction:
            bc1 = bias_correction(self.beta1, t)
            bc2 = bias_correction(self.beta2, t)
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32, device=dev)
        b1, b2, eps = self.beta1, self.beta2, self.eps
        f32 = torch.float32
        p32 = [p.to(f32) for p in tree_leaves(params)]
        g32 = [g.to(f32) for g in tree_leaves(grads)]
        if not self.adam_w_mode:  # ADAM_MODE_0: L2 into the grad
            g32 = torch._foreach_add(g32, torch._foreach_mul(p32, wd))
        m = torch._foreach_add(
            torch._foreach_mul(tree_leaves(state.exp_avg), b1),
            torch._foreach_mul(g32, 1.0 - b1))
        v = torch._foreach_add(
            torch._foreach_mul(tree_leaves(state.exp_avg_sq), b2),
            torch._foreach_mul(torch._foreach_mul(g32, 1.0 - b2), g32))
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(v, bc2)), eps)
        update = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        if self.adam_w_mode:  # ADAM_MODE_1: decoupled decay
            update = torch._foreach_add(update, torch._foreach_mul(p32, wd))
        new_p = torch._foreach_sub(p32, torch._foreach_mul(update, lr))
        new_p = [n.to(p.dtype) for n, p in zip(new_p, tree_leaves(params))]
        spec = tree_structure(params)
        return (tree_unflatten(new_p, spec),
                AdamState(step=t, exp_avg=tree_unflatten(m, spec),
                          exp_avg_sq=tree_unflatten(v, spec)))


class AdagradState(NamedTuple):
    step: torch.Tensor  # int32 0-d, the count of applied steps
    sum_sq: Any         # h, fp32


class FusedAdagrad(OptimizerBase):
    """Adagrad over a tree of parameters, with L2 decay folded into the
    grad (mode 0) or AdamW-style decoupled decay (``adagrad_w_mode``,
    mode 1)."""

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, adagrad_w_mode: bool = False):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.adagrad_w_mode = adagrad_w_mode

    def init(self, params: Any) -> AdagradState:
        return AdagradState(step=step_zero(params),
                            sum_sq=tree_zeros_like_f32(params))

    def _step(self, grads: Any, state: AdagradState, params: Any,
              lr: Optional[Any] = None) -> Tuple[Any, AdagradState]:
        dev = state.step.device
        f32 = torch.float32
        lr = torch.as_tensor(self.lr if lr is None else lr, dtype=f32,
                             device=dev)
        wd = torch.as_tensor(self.weight_decay, dtype=f32, device=dev)
        p32 = [p.to(f32) for p in tree_leaves(params)]
        g32 = [g.to(f32) for g in tree_leaves(grads)]
        if not self.adagrad_w_mode:
            g32 = torch._foreach_add(g32, torch._foreach_mul(p32, wd))
        h = torch._foreach_add(tree_leaves(state.sum_sq),
                               torch._foreach_mul(g32, g32))
        update = torch._foreach_div(
            g32, torch._foreach_add(torch._foreach_sqrt(h), self.eps))
        if self.adagrad_w_mode:
            update = torch._foreach_add(update, torch._foreach_mul(p32, wd))
        new_p = torch._foreach_sub(p32, torch._foreach_mul(update, lr))
        new_p = [n.to(p.dtype) for n, p in zip(new_p, tree_leaves(params))]
        spec = tree_structure(params)
        return (tree_unflatten(new_p, spec),
                AdagradState(step=state.step + 1,
                             sum_sq=tree_unflatten(h, spec)))
