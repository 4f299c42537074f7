"""Model-parallel-aware dynamic loss scaling.

Counterpart of ``apex_tpu/transformer/amp/grad_scaler.py``: a
:class:`~apex_tpu_torch.amp.DynamicLossScale` whose finite flag is reduced
over the model-parallel group before the scale update and the skip, so
every shard keeps or skips the step together. The port runs on one
device: there the synced flag is :func:`~apex_tpu_torch.amp.all_finite`,
and an initialized ``torch.distributed`` group of more than one rank
raises (multi-GPU is queue item A5).
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
        """The finite flag over the model-parallel group: at one device,
        :func:`all_finite` of ``grads``."""
        dist = torch.distributed
        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise NotImplementedError(
                "GradScaler.all_finite_synced over a process group of "
                f"{dist.get_world_size()} ranks: the port runs on one "
                "device; the model-parallel reduction comes with "
                "multi-GPU (A5)")
        return all_finite(grads)

    def update(self, state: LossScaleState,
               grads_finite: torch.Tensor) -> LossScaleState:
        return self._inner.update(state, grads_finite)
