"""Shared machinery of the port's fused optimizers.

Counterpart of ``apex_tpu/optimizers/_base.py``. The protocol is the
reference's::

    opt = FusedAdam(lr=1e-3)
    state = opt.init(params)
    params, state = opt.step(grads, state, params, grads_finite=finite)

with ``params`` and ``grads`` trees of tensors (for a module,
``dict(model.named_parameters())`` and the matching ``.grad`` tensors).
``step`` writes the new values into the tensors of ``params`` and ``state``
in place (the port's counterpart of the reference's donated buffers) and
returns them. With ``grads_finite`` (:func:`apex_tpu_torch.amp.all_finite`)
an overflow step keeps the old params *and* state, step count included,
selected on the device with ``torch.where``: no ``.item()`` per step.
``step`` records ``optim/grad_norm`` (:func:`global_grad_norm` of the grads
it is handed) into an open in-step collector
(:mod:`apex_tpu_torch.observability.ingraph`), thunked, so with none open
the norm is never computed. At health level ``"full"``
(:mod:`apex_tpu_torch.observability.health`) it also observes the grads
as it consumes them (``health/optim_grads/*``) and the params after the
skip (``health/params/*``); below that level, or with no collector open,
the observers add nothing. ``as_optax`` (an optax shim) is not ported.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.utils._pytree import TreeSpec, tree_leaves, tree_map

from apex_tpu_torch.amp.scaler import select_tree
from apex_tpu_torch.multi_tensor_apply.multi_tensor_apply import (
    tree_global_norm)
from apex_tpu_torch.observability import health as _health
from apex_tpu_torch.observability import ingraph as _metrics

__all__ = ["OptimizerBase", "bias_correction", "step_zero",
           "tree_zeros_like_f32",
           "tree_unzip", "global_grad_norm", "tree_global_norm"]


def global_grad_norm(grads: Any) -> torch.Tensor:
    """Global L2 norm of a grad tree, accumulated in fp32 (the quantity
    LAMB's global grad-norm clip computes): :func:`~apex_tpu_torch.
    multi_tensor_apply.tree_global_norm`."""
    return tree_global_norm(grads)


def tree_unzip(out: Any, treedef: TreeSpec, k: int) -> Tuple[Any, ...]:
    """Split a tree whose leaves are k-tuples into k trees of ``treedef``.
    ``k`` is explicit so empty trees (no leaves) still unzip."""
    leaves = treedef.flatten_up_to(out)
    return tuple(treedef.unflatten([leaf[i] for leaf in leaves])
                 for i in range(k))


def tree_zeros_like_f32(params: Any) -> Any:
    """fp32 zeros shaped like ``params``: optimizer state is fp32 whatever
    the parameters' dtype."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def step_zero(params: Any) -> torch.Tensor:
    """An optimizer state's int32 0-d step count, 0, on the parameters'
    device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def bias_correction(beta: float, step: torch.Tensor) -> torch.Tensor:
    """``1 - beta**t`` as an fp32 0-d tensor on ``step``'s device (``t``
    the 1-based step count)."""
    b = torch.tensor(beta, dtype=torch.float32, device=step.device)
    return 1.0 - torch.pow(b, step.to(torch.float32))


class OptimizerBase:
    """The overflow-skip wrapper around an optimizer's functional
    ``_step``."""

    def init(self, params: Any) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def _step(self, grads: Any, state: Any, params: Any,
              **kw) -> Tuple[Any, Any]:
        raise NotImplementedError  # pragma: no cover - abstract

    @torch.no_grad()
    def step(self, grads: Any, state: Any, params: Any,
             grads_finite: Optional[torch.Tensor] = None,
             **kw) -> Tuple[Any, Any]:
        _metrics.record("optim/grad_norm", lambda: global_grad_norm(grads),
                        reduce="mean")
        # the grads as this optimizer consumes them (after the unscale and
        # the sync), named apart from amp's "grads"
        _health.observe_tree(grads, "optim_grads", min_level="full")
        new_params, new_state = self._step(grads, state, params, **kw)
        if grads_finite is not None:
            # skip = old params AND old state (the step count does not
            # advance), as the reference skips optimizer.step() wholesale
            new_params = select_tree(grads_finite, new_params, params)
            new_state = _select_tensors(grads_finite, new_state, state)
        for old, new in zip(tree_leaves((params, state)),
                            tree_leaves((new_params, new_state))):
            if isinstance(old, torch.Tensor):
                old.copy_(new)
        # the params after the skip: a growing health/params/abs_max is
        # the earliest warning of an overflow to come
        _health.observe_tree(params, "params", min_level="full")
        return params, state


def _select_tensors(pred: torch.Tensor, new: Any, old: Any) -> Any:
    """:func:`select_tree` over the tensor leaves of a state; a host
    constant of the state (ZeRO's ``bucket_stamp``) stays as it is."""
    return tree_map(lambda n, o: torch.where(pred, n, o)
                    if isinstance(n, torch.Tensor) else n, new, old)
