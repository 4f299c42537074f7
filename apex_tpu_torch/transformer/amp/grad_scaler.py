"""Model-parallel-aware dynamic loss scaling.

Counterpart of ``apex_tpu/transformer/amp/grad_scaler.py``: a
:class:`~apex_tpu_torch.amp.DynamicLossScale` whose finite flag is reduced
over the model-parallel group before the scale update and the skip, so
every shard keeps or skips the step together: a MIN of the finite flag
over the groups of ``model_parallel_axes`` (mesh axis names of
:mod:`apex_tpu_torch.transformer.parallel_state`), the reference's MAX
all-reduce of ``found_inf``. Before ``initialize_model_parallel`` a
single process has no model-parallel peers, so the flag is
:func:`~apex_tpu_torch.amp.all_finite` of its own grads; with more than
one rank the axes must be bound, or it raises ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from apex_tpu_torch.amp.scaler import (DynamicLossScale, LossScaleState,
                                       all_finite)

__all__ = ["GradScaler"]

# the reference's mesh axis names (apex_tpu/transformer/parallel_state.py)
TENSOR_AXIS = "tensor"
PIPE_AXIS = "pipe"


class GradScaler:
    """Functional grad scaler synchronized over the model-parallel
    group::

        scaler = GradScaler(init_scale=2**16)
        state = scaler.init()
        finite = scaler.all_finite_synced(grads)
        state = scaler.update(state, finite)
        params, opt_state = opt.step(grads, opt_state, params,
                                     grads_finite=finite)
    """

    def __init__(self, init_scale: float = 2.0 ** 16,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000,
                 model_parallel_axes: Sequence[str] = (TENSOR_AXIS,
                                                       PIPE_AXIS)):
        self._inner = DynamicLossScale(
            init_scale=init_scale, growth_factor=growth_factor,
            backoff_factor=backoff_factor, growth_interval=growth_interval)
        self.model_parallel_axes = tuple(model_parallel_axes)

    def init(self, device="cuda") -> LossScaleState:
        return self._inner.init(device=device)

    def scale(self, state: LossScaleState, tree: Any) -> Any:
        return self._inner.scale(state, tree)

    def unscale(self, state: LossScaleState, grads: Any,
                cast_to: torch.dtype = torch.float32) -> Any:
        return self._inner.unscale(state, grads, cast_to)

    def all_finite_synced(self, grads: Any) -> torch.Tensor:
        """The finite flag of ``grads`` reduced over the model-parallel
        group (the module's docstring)."""
        from apex_tpu_torch.transformer import parallel_state
        dist = torch.distributed
        if not parallel_state.model_parallel_is_initialized():
            if (dist.is_available() and dist.is_initialized()
                    and dist.get_world_size() > 1):
                raise ValueError(
                    f"model-parallel axes {self.model_parallel_axes} are "
                    "not bound: parallel_state is not initialized over a "
                    f"world of {dist.get_world_size()} ranks (call "
                    "initialize_model_parallel first)")
            return all_finite(grads)
        return all_finite(grads, axis_names=self.model_parallel_axes)

    def update(self, state: LossScaleState,
               grads_finite: torch.Tensor) -> LossScaleState:
        return self._inner.update(state, grads_finite)
