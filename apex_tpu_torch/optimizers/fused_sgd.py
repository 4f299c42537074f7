"""FusedSGD for the port.

Counterpart of ``apex_tpu/optimizers/fused_sgd.py`` (the arithmetic of
apex's ``multi_tensor_sgd_kernel.cu``)::

    g = grad * scale                         (the fused unscale)
    g = g + wd * p                           unless wd_after_momentum
    buf = g on the first step, else momentum * buf + (1 - dampening) * g
    d = g + momentum * buf if nesterov else buf     (d = g at momentum 0)
    d = d + wd * p                           if wd_after_momentum
    p = p - lr * d

in fp32 whatever the parameters' dtype, as ``torch._foreach_*`` passes
over the parameter list (the JAX package leaves the fusion to XLA; no
Pallas kernel is involved). ``scale`` may be a 0-d tensor, such as ``1 /
loss_scale``, so the unscale costs no pass of its own and no host sync.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_structure, tree_unflatten

from apex_tpu_torch.optimizers._base import (
    OptimizerBase, step_zero, tree_zeros_like_f32)

__all__ = ["FusedSGD", "SGDState"]


class SGDState(NamedTuple):
    step: torch.Tensor   # int32 0-d; 0 means the momentum is unseeded
    momentum_buf: Any    # fp32


class FusedSGD(OptimizerBase):
    """Momentum SGD over a tree of parameters. ``materialize_master_grads``
    is accepted for the reference's API and changes nothing: grads are
    widened to fp32 inside the update."""

    def __init__(self, lr: float = 1e-3, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, wd_after_momentum: bool = False,
                 materialize_master_grads: bool = True):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        self.lr = lr
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum
        self.materialize_master_grads = materialize_master_grads

    def init(self, params: Any) -> SGDState:
        return SGDState(step=step_zero(params),
                        momentum_buf=tree_zeros_like_f32(params))

    def _step(self, grads: Any, state: SGDState, params: Any,
              lr: Optional[Any] = None,
              scale: Any = 1.0) -> Tuple[Any, SGDState]:
        dev = state.step.device
        f32 = torch.float32
        lr = torch.as_tensor(self.lr if lr is None else lr, dtype=f32,
                             device=dev)
        scale = torch.as_tensor(scale, dtype=f32, device=dev)
        wd = torch.as_tensor(self.weight_decay, dtype=f32, device=dev)
        mom, damp = self.momentum, self.dampening
        p32 = [p.to(f32) for p in tree_leaves(params)]
        g32 = torch._foreach_mul([g.to(f32) for g in tree_leaves(grads)],
                                 scale)
        if not self.wd_after_momentum:
            g32 = torch._foreach_add(g32, torch._foreach_mul(p32, wd))
        buf = state.momentum_buf
        if mom != 0.0:
            # the first step seeds buf = g
            first_run = state.step == 0
            later = torch._foreach_add(
                torch._foreach_mul(tree_leaves(buf), mom),
                torch._foreach_mul(g32, 1.0 - damp))
            seeded = [torch.where(first_run, g, b)
                      for g, b in zip(g32, later)]
            step_dir = (torch._foreach_add(g32, torch._foreach_mul(
                seeded, mom)) if self.nesterov else seeded)
            buf = tree_unflatten(seeded, tree_structure(params))
        else:
            step_dir = g32
        if self.wd_after_momentum:
            step_dir = torch._foreach_add(step_dir,
                                          torch._foreach_mul(p32, wd))
        new_p = torch._foreach_sub(p32, torch._foreach_mul(step_dir, lr))
        new_p = [n.to(p.dtype) for n, p in zip(new_p, tree_leaves(params))]
        return (tree_unflatten(new_p, tree_structure(params)),
                SGDState(step=state.step + 1, momentum_buf=buf))
