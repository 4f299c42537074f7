"""LARC, layer-wise adaptive rate clipping, as a transform of the grads.

Counterpart of ``apex_tpu/optimizers/larc.py`` (apex's ``LARC.step``).
Per tensor, with ``wd`` the wrapped optimizer's weight decay::

    adaptive_lr = trust_coefficient * ||p|| / (||g|| + ||p|| * wd + eps)
    adaptive_lr = min(adaptive_lr / lr, 1)        with clip
    g = (g + wd * p) * adaptive_lr                where ||p|| and ||g|| != 0

(a grad stays untouched, decay included, where either norm is 0). The
decay is absorbed into the grad, so the wrapped optimizer then runs with
its decay off. The norms are
:func:`~apex_tpu_torch.multi_tensor_apply.tensor_norms` in fp32 and the
rest ``torch._foreach_*`` passes; no value is read back to the host.
"""

from __future__ import annotations

import inspect
from typing import Any, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_structure, tree_unflatten

from apex_tpu_torch.multi_tensor_apply import tensor_norms
from apex_tpu_torch.optimizers._base import OptimizerBase

__all__ = ["LARC", "larc_transform_grads"]


def larc_transform_grads(grads: Any, params: Any, lr: Any,
                         trust_coefficient: float = 0.02,
                         clip: bool = True, eps: float = 1e-8,
                         weight_decay: Any = 0.0) -> Any:
    """The per-tensor LARC rewrite of ``grads`` (each leaf in its own
    dtype)."""
    g_leaves = tree_leaves(grads)
    if not g_leaves:
        return grads
    f32 = torch.float32
    dev = g_leaves[0].device
    lr = torch.as_tensor(lr, dtype=f32, device=dev)
    wd = torch.as_tensor(weight_decay, dtype=f32, device=dev)
    g32 = [g.to(f32) for g in g_leaves]
    p32 = [p.to(f32) for p in tree_leaves(params)]
    pn = tensor_norms(p32)
    gn = tensor_norms(g32)
    adaptive_lr = trust_coefficient * pn / (gn + pn * wd + eps)
    if clip:
        adaptive_lr = torch.minimum(adaptive_lr / lr, torch.ones_like(pn))
    decayed = torch._foreach_add(g32, torch._foreach_mul(p32, wd))
    # an untouched grad (no decay either) where a norm is zero
    active = ((pn != 0.0) & (gn != 0.0)).unbind()
    new_g = [torch.where(a, d * r, g) for a, d, r, g in
             zip(active, decayed, adaptive_lr.unbind(), g32)]
    return tree_unflatten([n.to(g.dtype) for n, g in zip(new_g, g_leaves)],
                          tree_structure(grads))


class LARC(OptimizerBase):
    """The LARC transform, then the wrapped optimizer with its weight decay
    absorbed: it gets ``weight_decay=0.0`` where its ``_step`` takes that
    argument, else its ``weight_decay`` attribute reads 0 for the call."""

    def __init__(self, optimizer: OptimizerBase,
                 trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    def init(self, params: Any) -> Any:
        return self.optim.init(params)

    def _step(self, grads: Any, state: Any, params: Any,
              lr: Optional[Any] = None, **kw) -> Tuple[Any, Any]:
        eff_lr = self.optim.lr if lr is None else lr
        wd = getattr(self.optim, "weight_decay", 0.0)
        grads = larc_transform_grads(grads, params, eff_lr,
                                     self.trust_coefficient, self.clip,
                                     self.eps, weight_decay=wd)
        if "weight_decay" in inspect.signature(self.optim._step).parameters:
            return self.optim._step(grads, state, params, lr=lr,
                                    weight_decay=0.0, **kw)
        saved = getattr(self.optim, "weight_decay", None)
        if saved is None:
            return self.optim._step(grads, state, params, lr=lr, **kw)
        self.optim.weight_decay = 0.0
        try:
            return self.optim._step(grads, state, params, lr=lr, **kw)
        finally:
            self.optim.weight_decay = saved
