"""FusedNovoGrad for the port: NovoGrad with a per-tensor second moment.

Counterpart of ``apex_tpu/optimizers/fused_novograd.py`` (the arithmetic
of apex's ``multi_tensor_novograd.cu``). The second moment is one fp32
scalar a tensor, an EMA of the grad's *norm* (L2 with ``norm_type=2``,
L-inf with ``norm_type=0``): L2 blends in RMS form, ``sqrt(b2 * v**2 + (1
- b2) * ||g||**2)``, L-inf linearly, ``b2 * v + (1 - b2) * ||g||``; unless
``init_zero``, the first step seeds ``v = ||g||``. Its bias correction
carries a square root, ``sqrt(1 - b2**t)``. With ``denom = v / bc2 +
eps``::

    reg_inside_moment (MOMENT_MODE_0):  m = b1 * m + beta3 * (g / denom + wd * p)
                                        p = p - lr * (m / bc1)
    default (MOMENT_MODE_1):            m = b1 * m + beta3 * g
                                        p = p - lr * ((m / bc1) / denom + wd * p)

in fp32, as ``torch._foreach_*`` passes (the norms by
:func:`~apex_tpu_torch.multi_tensor_apply.tensor_norms`, the scalars as
one vector); no value is read back
to the host.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import (tree_leaves, tree_map, tree_structure,
                                 tree_unflatten)

from apex_tpu_torch.multi_tensor_apply import tensor_norms
from apex_tpu_torch.optimizers._base import (
    OptimizerBase, bias_correction, step_zero, tree_zeros_like_f32)

__all__ = ["FusedNovoGrad", "NovoGradState"]


class NovoGradState(NamedTuple):
    step: torch.Tensor  # int32 0-d, the count of applied steps
    exp_avg: Any        # momentum, fp32, per element
    exp_avg_sq: Any     # the norm EMA, fp32, one 0-d tensor a tensor


class FusedNovoGrad(OptimizerBase):
    """NovoGrad over a tree of parameters; ``amsgrad`` and norms other than
    L2 and L-inf raise, as in the reference."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.95, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, reg_inside_moment: bool = False,
                 grad_averaging: bool = True, norm_type: int = 2,
                 init_zero: bool = False, amsgrad: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedNovoGrad does not support the AMSGrad variant.")
        if norm_type not in (0, 2):
            raise RuntimeError("FusedNovoGrad only supports l2/inf norm.")
        self.lr = lr
        self.use_bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.reg_inside_moment = reg_inside_moment
        self.grad_averaging = grad_averaging
        self.norm_type = norm_type
        self.init_zero = init_zero

    def init(self, params: Any) -> NovoGradState:
        return NovoGradState(
            step=step_zero(params), exp_avg=tree_zeros_like_f32(params),
            exp_avg_sq=tree_map(lambda p: torch.zeros(
                (), dtype=torch.float32, device=p.device), params))

    def _step(self, grads: Any, state: NovoGradState, params: Any,
              lr: Optional[Any] = None) -> Tuple[Any, NovoGradState]:
        dev = state.step.device
        f32 = torch.float32
        lr = torch.as_tensor(self.lr if lr is None else lr, dtype=f32,
                             device=dev)
        wd = torch.as_tensor(self.weight_decay, dtype=f32, device=dev)
        t = state.step + 1
        if self.use_bias_correction:
            bc1 = bias_correction(self.beta1, t)
            # v is an EMA of norms: its correction carries a sqrt
            bc2 = torch.sqrt(bias_correction(self.beta2, t))
        else:
            bc1 = bc2 = torch.ones((), dtype=f32, device=dev)
        b1, b2, eps = self.beta1, self.beta2, self.eps
        beta3 = (1.0 - b1) if self.grad_averaging else 1.0
        spec = tree_structure(params)
        p_leaves = tree_leaves(params)
        if not p_leaves:
            return params, NovoGradState(step=t, exp_avg=state.exp_avg,
                                         exp_avg_sq=state.exp_avg_sq)
        p32 = [p.to(f32) for p in p_leaves]
        g32 = [g.to(f32) for g in tree_leaves(grads)]
        gn = tensor_norms(g32, self.norm_type)
        v = torch.stack(tree_leaves(state.exp_avg_sq))
        if self.norm_type == 2:   # L2 blends in RMS form
            blended = torch.sqrt(b2 * v * v + (1.0 - b2) * gn * gn)
        else:                     # L-inf linearly
            blended = b2 * v + (1.0 - b2) * gn
        # the first step seeds v = ||g||, so its blend is the identity
        new_v = (blended if self.init_zero
                 else torch.where(state.step == 0, gn, blended))
        denom = list((new_v / bc2 + eps).unbind())
        m = tree_leaves(state.exp_avg)
        if self.reg_inside_moment:   # MOMENT_MODE_0
            gg = torch._foreach_add(torch._foreach_div(g32, denom),
                                    torch._foreach_mul(p32, wd))
            m = torch._foreach_add(torch._foreach_mul(m, b1),
                                   torch._foreach_mul(gg, beta3))
            step_dir = torch._foreach_div(m, bc1)
        else:                        # MOMENT_MODE_1
            m = torch._foreach_add(torch._foreach_mul(m, b1),
                                   torch._foreach_mul(g32, beta3))
            step_dir = torch._foreach_add(
                torch._foreach_div(torch._foreach_div(m, bc1), denom),
                torch._foreach_mul(p32, wd))
        new_p = torch._foreach_sub(p32, torch._foreach_mul(step_dir, lr))
        new_p = [n.to(p.dtype) for n, p in zip(new_p, p_leaves)]
        return (tree_unflatten(new_p, spec),
                NovoGradState(step=t, exp_avg=tree_unflatten(m, spec),
                              exp_avg_sq=tree_unflatten(
                                  list(new_v.unbind()), spec)))
