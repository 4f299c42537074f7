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
The reference's grad-norm and health telemetry come with the observability
slice.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from apex_tpu_torch.amp.scaler import select_tree

__all__ = ["OptimizerBase", "bias_correction", "tree_zeros_like_f32"]


def tree_zeros_like_f32(params: Any) -> Any:
    """fp32 zeros shaped like ``params``: optimizer state is fp32 whatever
    the parameters' dtype."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


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
        new_params, new_state = self._step(grads, state, params, **kw)
        if grads_finite is not None:
            # skip = old params AND old state (the step count does not
            # advance), as the reference skips optimizer.step() wholesale
            new_params = select_tree(grads_finite, new_params, params)
            new_state = select_tree(grads_finite, new_state, state)
        for old, new in zip(tree_leaves((params, state)),
                            tree_leaves((new_params, new_state))):
            old.copy_(new)
        return params, state
