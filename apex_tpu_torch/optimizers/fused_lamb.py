"""FusedLAMB and FusedMixedPrecisionLamb for the port.

Counterpart of ``apex_tpu/optimizers/fused_lamb.py``, the arithmetic of
apex's ``multi_tensor_lamb.cu`` in two phases:

1. the global grad norm (``tree_global_norm`` of the grads, over
   ``grad_scale``) and the clip coefficient ``gn / max_grad_norm`` where
   ``gn > max_grad_norm``, else 1, both computed on the device;
2. per tensor, an Adam-style update of the clipped grad (MOMENT_MODE_0,
   ``adam_w_mode=False``, folds ``wd * p`` into the grad; MOMENT_MODE_1
   appends it to the update), then the trust ratio ``lr * ||p|| /
   ||update||``, ``lr`` where either norm is 0, applied only where
   ``use_nvlamb`` or ``wd != 0`` (``lr`` elsewhere)::

       g = grad / grad_scale / clip   [+ wd * p]
       m = b1 * m + beta3 * g         (beta3 = 1 - b1 with grad_averaging)
       v = b2 * v + (1 - b2) * g * g
       update = (m / bc1) / (sqrt(v / bc2) + eps)   [+ wd * p]
       p = p - ratio * update

in fp32 whatever the parameters' dtype, as ``torch._foreach_*`` passes
over the parameter list (the per-tensor norms by
:func:`~apex_tpu_torch.multi_tensor_apply.tensor_norms`, the ratios as
one vector); no value is read back to the host.
``FusedMixedPrecisionLamb`` runs the same update on fp32 master copies
of the parameters and regenerates the model's (low-precision) parameters
from them; ``grad_scale``, the live loss scale, divides the grads inside
the update, so the scaled grads go in as they are.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import (tree_leaves, tree_map, tree_structure,
                                 tree_unflatten)

from apex_tpu_torch.multi_tensor_apply import tensor_norms, tree_global_norm
from apex_tpu_torch.optimizers._base import (
    OptimizerBase, bias_correction, step_zero, tree_zeros_like_f32)

__all__ = ["FusedLAMB", "LAMBState", "FusedMixedPrecisionLamb",
           "MixedPrecisionLambState"]


class LAMBState(NamedTuple):
    step: torch.Tensor  # int32 0-d, the count of applied steps
    exp_avg: Any        # m, fp32
    exp_avg_sq: Any     # v, fp32


class FusedLAMB(OptimizerBase):
    """LAMB over a tree of parameters; ``amsgrad`` raises, as in the
    reference."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, adam_w_mode: bool = True,
                 grad_averaging: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, amsgrad: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        self.lr = lr
        self.use_bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb

    def init(self, params: Any) -> LAMBState:
        return LAMBState(step=step_zero(params),
                         exp_avg=tree_zeros_like_f32(params),
                         exp_avg_sq=tree_zeros_like_f32(params))

    def _step(self, grads: Any, state: LAMBState, params: Any,
              lr: Optional[Any] = None,
              weight_decay: Optional[Any] = None,
              grad_scale: Any = 1.0) -> Tuple[Any, LAMBState]:
        dev = state.step.device
        f32 = torch.float32
        lr = torch.as_tensor(self.lr if lr is None else lr, dtype=f32,
                             device=dev)
        wd = torch.as_tensor(
            self.weight_decay if weight_decay is None else weight_decay,
            dtype=f32, device=dev)
        inv_gs = 1.0 / torch.as_tensor(grad_scale, dtype=f32, device=dev)
        t = state.step + 1
        if self.use_bias_correction:
            bc1 = bias_correction(self.beta1, t)
            bc2 = bias_correction(self.beta2, t)
        else:
            bc1 = bc2 = torch.ones((), dtype=f32, device=dev)
        b1, b2, eps = self.beta1, self.beta2, self.eps
        beta3 = (1.0 - b1) if self.grad_averaging else 1.0
        spec = tree_structure(params)
        p_leaves = tree_leaves(params)
        if not p_leaves:
            return params, LAMBState(step=t, exp_avg=state.exp_avg,
                                     exp_avg_sq=state.exp_avg_sq)

        # phase 1: the global grad-norm clip coefficient
        gnorm = tree_global_norm(grads) * inv_gs
        clip = torch.where(gnorm > self.max_grad_norm,
                           gnorm / self.max_grad_norm, 1.0)

        # phase 2: the per-tensor update
        p32 = [p.to(f32) for p in p_leaves]
        sg = torch._foreach_div(torch._foreach_mul(
            [g.to(f32) for g in tree_leaves(grads)], inv_gs), clip)
        if not self.adam_w_mode:  # MOMENT_MODE_0: L2 on the clipped grad
            sg = torch._foreach_add(sg, torch._foreach_mul(p32, wd))
        m = torch._foreach_add(
            torch._foreach_mul(tree_leaves(state.exp_avg), b1),
            torch._foreach_mul(sg, beta3))
        v = torch._foreach_add(
            torch._foreach_mul(tree_leaves(state.exp_avg_sq), b2),
            torch._foreach_mul(torch._foreach_mul(sg, 1.0 - b2), sg))
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(v, bc2)), eps)
        update = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        if self.adam_w_mode:  # MOMENT_MODE_1: decoupled decay
            update = torch._foreach_add(update, torch._foreach_mul(p32, wd))
        # the per-tensor trust ratio
        pnorm = tensor_norms(p32)
        unorm = tensor_norms(update)
        ratio = torch.where((pnorm != 0.0) & (unorm != 0.0),
                            lr * pnorm / unorm, lr)
        if not self.use_nvlamb:  # the ratio only for decayed params
            ratio = torch.where(wd != 0.0, ratio, lr)
        new_p = torch._foreach_sub(
            p32, torch._foreach_mul(update, list(ratio.unbind())))
        new_p = [n.to(p.dtype) for n, p in zip(new_p, p_leaves)]
        return (tree_unflatten(new_p, spec),
                LAMBState(step=t, exp_avg=tree_unflatten(m, spec),
                          exp_avg_sq=tree_unflatten(v, spec)))


class MixedPrecisionLambState(NamedTuple):
    step: torch.Tensor
    master_params: Any  # fp32
    exp_avg: Any
    exp_avg_sq: Any


class FusedMixedPrecisionLamb(OptimizerBase):
    """LAMB over fp32 masters, the model's parameters regenerated from
    them after each step; ``grad_scale`` (the live loss scale) divides the
    grads inside the update, so the scaled grads go in directly."""

    def __init__(self, **lamb_kwargs):
        self._lamb = FusedLAMB(**lamb_kwargs)
        # the inner hyperparameters, for wrappers (LARC) and schedules
        self.lr = self._lamb.lr
        self.weight_decay = self._lamb.weight_decay

    def init(self, params: Any) -> MixedPrecisionLambState:
        master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                          params)
        inner = self._lamb.init(params)
        return MixedPrecisionLambState(
            step=inner.step, master_params=master,
            exp_avg=inner.exp_avg, exp_avg_sq=inner.exp_avg_sq)

    def _step(self, grads: Any, state: MixedPrecisionLambState, params: Any,
              lr: Optional[Any] = None, weight_decay: Optional[Any] = None,
              grad_scale: Any = 1.0) -> Tuple[Any, MixedPrecisionLambState]:
        if lr is None:
            lr = self.lr
        if weight_decay is None:
            weight_decay = self.weight_decay
        inner_state = LAMBState(state.step, state.exp_avg, state.exp_avg_sq)
        new_master, new_inner = self._lamb._step(
            grads, inner_state, state.master_params, lr=lr,
            weight_decay=weight_decay, grad_scale=grad_scale)
        new_params = tree_map(lambda mp, p: mp.to(p.dtype), new_master,
                              params)
        return new_params, MixedPrecisionLambState(
            step=new_inner.step, master_params=new_master,
            exp_avg=new_inner.exp_avg, exp_avg_sq=new_inner.exp_avg_sq)
