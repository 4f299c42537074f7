"""fp16_utils: the pre-amp manual mixed-precision surface, over the port's
amp and optimizers.

Counterpart of ``apex_tpu/fp16_utils/__init__.py``: ``FP16_Optimizer``
keeps fp32 master params and a loss scale around any of the port's
optimizers, the network casts work on trees of tensors, and the
loss-scaler names alias the amp scalers. Where the reference returns new
trees, the port writes the model's (half) params in place from the fp32
master, as apex's original does.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from apex_tpu_torch.amp.policy import cast_floating
from apex_tpu_torch.amp.scaler import (DynamicLossScale, StaticLossScale,
                                       all_finite)

__all__ = ["FP16_Optimizer", "network_to_half", "convert_network",
           "LossScaler", "DynamicLossScaler",
           "master_params_to_model_params", "prep_param_lists"]

# the fp16_utils scalers are the amp ones: the same protocol
LossScaler = StaticLossScale
DynamicLossScaler = DynamicLossScale


def network_to_half(params: Any) -> Any:
    """Float leaves to fp16 (bf16 through ``convert_network(params,
    torch.bfloat16)``)."""
    return cast_floating(params, torch.float16)


def convert_network(params: Any, dtype: torch.dtype) -> Any:
    """Float leaves to ``dtype``."""
    return cast_floating(params, dtype)


def _master_copy(params: Any) -> Any:
    # a fresh fp32 tensor per float leaf, even for fp32 leaves: the master
    # is updated in place and must not alias the model's params
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True)
                    if isinstance(p, torch.Tensor) and p.is_floating_point()
                    else p, params)


def prep_param_lists(params: Any) -> Tuple[Any, Any]:
    """``(model_params, master_params)``: the master an fp32 copy of the
    tree."""
    return params, _master_copy(params)


@torch.no_grad()
def master_params_to_model_params(model_params: Any,
                                  master_params: Any) -> Any:
    """Copy the master values into the model's tensors, in place, each
    rounded to its model dtype; returns ``model_params``."""
    for mp, ma in zip(tree_leaves(model_params), tree_leaves(master_params)):
        mp.copy_(ma)
    return model_params


class FP16_Optimizer:
    """fp32 master params and loss scaling around a port optimizer::

        opt = FP16_Optimizer(FusedAdam(lr=1e-3), dynamic_loss_scale=True)
        state = opt.init(half_params)
        half_params, state = opt.step(grads, state, half_params)

    ``state`` is ``(master_params_fp32, inner_state, LossScaleState)``, the
    scale state on the params' device. Grads (of the loss scaled by
    :meth:`scale_loss`) may be half: they are unscaled into fp32 before
    the update, an overflow skips it (master and inner state kept) and
    adjusts the scale, and the half params are then written in place
    from the master.
    """

    def __init__(self, inner, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False, **scale_kw):
        self.inner = inner
        self.scaler = (DynamicLossScale(**scale_kw) if dynamic_loss_scale
                       else StaticLossScale(static_loss_scale))

    def init(self, params: Any):
        master = _master_copy(params)
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else "cpu"
        return (master, self.inner.init(master),
                self.scaler.init(device=device))

    def scale_loss(self, state, loss):
        """The ``optimizer.backward(loss)`` pre-scale."""
        return self.scaler.scale(state[2], loss)

    def step(self, grads: Any, state, params: Any, **kw) -> Tuple[Any, Any]:
        master, inner_state, ls = state
        grads32 = self.scaler.unscale(ls, grads)
        finite = all_finite(grads32)
        new_ls = self.scaler.update(ls, finite)
        self.inner.step(grads32, inner_state, master, grads_finite=finite,
                        **kw)
        master_params_to_model_params(params, master)
        return params, (master, inner_state, new_ls)
