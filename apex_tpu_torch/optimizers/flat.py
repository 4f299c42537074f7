"""FlatOptimizer: an elementwise optimizer over one flat fp32 buffer.

Counterpart of ``apex_tpu/optimizers/flat.py``, the single-device
``multi_tensor_apply`` tier: the wrapped optimizer's update runs over one
contiguous fp32 vector instead of a tree of small leaves. Flattening
commutes with an elementwise update, so the values are the wrapped
optimizer's. Two tiers:

* **Persistent flat** — :meth:`~FlatOptimizer.init_flat` ravels the
  params once into a resident fp32 master vector; :meth:`unflatten`
  gives the model its parameters as views of it (fp32 leaves are views,
  other dtypes cast copies), so a loss read through them, e.g. with
  ``torch.func.functional_call(model, opt.unflatten(flat), ...)``, gives
  one flat gradient and no step ravels or unravels anything::

      opt = FlatOptimizer(FusedSGD(lr=0.1, momentum=0.9))
      fstate = opt.init_flat(params)
      flat = fstate.flat_params.requires_grad_()
      (g,) = torch.autograd.grad(loss(opt.unflatten(flat)), flat)
      opt.flat_step(g, fstate)                  # one pass, in place

* **Compat** — the plain ``init``/``step`` tree protocol: grads and params
  are raveled and the result unraveled every step (two extra passes over
  the parameters), then written into ``params`` in place, as every port
  optimizer's ``step`` does.

Only for optimizers whose math is elementwise over (grad, param, state):
``FusedAdam``, ``FusedAdagrad`` and ``FusedSGD``. The per-tensor norms of
LAMB, NovoGrad and LARC would span the whole buffer here (the reference's
ZeRO tier, ``distributed_fused.py``, keeps segment ids for them).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves

from apex_tpu_torch.amp.scaler import select_tree
from apex_tpu_torch.optimizers._base import OptimizerBase
from apex_tpu_torch.optimizers._flatten import build_layout, ravel, unravel

__all__ = ["FlatOptimizer", "FlatState"]


class FlatState(NamedTuple):
    """The persistent flat state: the fp32 master params and the wrapped
    optimizer's state, both over the one padded flat vector."""
    flat_params: torch.Tensor
    inner_state: Any


class FlatOptimizer(OptimizerBase):
    """``FlatOptimizer(FusedSGD(...))``: the wrapped update in one pass over
    a flat fp32 buffer. Params keep their tree shape and dtypes at the API
    boundary (bf16 params round-trip through the fp32 buffer)."""

    def __init__(self, inner: OptimizerBase):
        self.inner = inner
        self._layout = None

    def _layout_for(self, params: Any):
        lay = build_layout(params)
        if self._layout is not None and self._layout.shapes != lay.shapes:
            raise ValueError("parameter structure changed between calls")
        self._layout = lay
        return lay

    # -- persistent-flat tier ------------------------------------------------

    def init_flat(self, params: Any) -> FlatState:
        """Ravel ``params`` once into the resident fp32 master vector and
        build the wrapped optimizer's state over it."""
        lay = self._layout_for(params)
        flat = ravel(params, lay).detach()
        return FlatState(flat, self.inner.init(flat))

    def unflatten(self, flat_params: torch.Tensor) -> Any:
        """The tree of parameters over ``flat_params``: views for fp32
        leaves, cast copies for the others."""
        if self._layout is None:
            raise ValueError("call init_flat (or init) first")
        return unravel(flat_params, self._layout)

    def params_of(self, fstate: FlatState) -> Any:
        """Tree-shaped view of the current params (checkpoint, export)."""
        return self.unflatten(fstate.flat_params)

    @torch.no_grad()
    def flat_step(self, flat_grads: torch.Tensor, fstate: FlatState,
                  grads_finite: Optional[torch.Tensor] = None,
                  **kw) -> FlatState:
        """One elementwise pass over the flat buffers, written into
        ``fstate``'s tensors in place (returned). ``flat_grads`` is a
        gradient with respect to ``fstate.flat_params``; with
        ``grads_finite`` an overflow keeps the old values."""
        new = FlatState(*self.inner._step(
            flat_grads.to(torch.float32), fstate.inner_state,
            fstate.flat_params, **kw))
        if grads_finite is not None:
            new = select_tree(grads_finite, new, fstate)
        for old, value in zip(tree_leaves(fstate), tree_leaves(new)):
            old.copy_(value)
        return fstate

    # -- compat tree tier ----------------------------------------------------

    def init(self, params: Any) -> Any:
        lay = self._layout_for(params)
        return self.inner.init(ravel(params, lay).detach())

    def _step(self, grads: Any, state: Any, params: Any,
              **kw) -> Tuple[Any, Any]:
        lay = self._layout_for(params)
        new_flat, new_state = self.inner._step(
            ravel(grads, lay), state, ravel(params, lay), **kw)
        return unravel(new_flat, lay), new_state
