"""Loss scaling, on the device.

Counterpart of ``apex_tpu/amp/scaler.py``: the dynamic scale starts at
``init_scale``, halves on overflow and doubles after ``growth_interval``
consecutive clean steps, within ``[min_scale, max_scale]``; static scaling
is a constant multiplier. As in the reference, the whole protocol stays on
the device: :func:`all_finite` is one boolean tensor, the scale update is
branch-free (``torch.where``), and the optimizer skips a step by selecting
between old and new state (:func:`select_tree`), so no step waits on a
``.item()``. The state is two 0-d tensors.

Trees are ``dict``/``list``/``tuple`` of tensors (:mod:`torch.utils._pytree`).
The reference's telemetry hooks (loss-scale and overflow metrics, health
observers) come with the observability slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Union

import torch

from apex_tpu_torch._device import resolve_device
from torch.utils._pytree import tree_leaves, tree_map

__all__ = ["LossScaleState", "DynamicLossScale", "StaticLossScale",
           "NoOpLossScale", "make_loss_scale", "all_finite", "select_tree"]


class LossScaleState(NamedTuple):
    """Carried scaler state: ``(loss_scale, unskipped_steps)``."""

    loss_scale: torch.Tensor  # fp32 0-d
    unskipped: torch.Tensor   # int32 0-d


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def all_finite(tree: Any) -> torch.Tensor:
    """One boolean 0-d tensor: every floating leaf of ``tree`` is finite
    (the reference's fused finite-check; no host sync)."""
    leaves = [x for x in tree_leaves(tree) if _is_float(x)]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def select_tree(pred: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """``torch.where(pred, ...)`` over matching trees: the on-device skip."""
    return tree_map(lambda t, f: torch.where(pred, torch.as_tensor(t),
                                             torch.as_tensor(f)),
                    on_true, on_false)


def _init_state(scale: float, device) -> LossScaleState:
    dev = resolve_device(device)
    return LossScaleState(
        loss_scale=torch.tensor(scale, dtype=torch.float32, device=dev),
        unskipped=torch.tensor(0, dtype=torch.int32, device=dev))


def _scale(state: LossScaleState, tree: Any) -> Any:
    s = state.loss_scale

    def one(x):
        if not _is_float(x):
            return x
        # widen sub-fp32 dtypes for the multiply: a large scale overflows
        # fp16 if cast to it first
        wide = torch.promote_types(x.dtype, torch.float32)
        return (x.to(wide) * s.to(wide)).to(x.dtype)

    return tree_map(one, tree)


def _unscale(state: LossScaleState, grads: Any,
             cast_to: torch.dtype = torch.float32) -> Any:
    inv = 1.0 / state.loss_scale
    return tree_map(lambda g: g.to(cast_to) * inv if _is_float(g) else g,
                    grads)


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """Dynamic loss scaling config; ``init`` makes the state on
    ``device`` (default the card)."""

    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    def init(self, device="cuda") -> LossScaleState:
        return _init_state(self.init_scale, device)

    def scale(self, state: LossScaleState, tree: Any) -> Any:
        return _scale(state, tree)

    def unscale(self, state: LossScaleState, grads: Any,
                cast_to: torch.dtype = torch.float32) -> Any:
        """Grads widened to ``cast_to`` *before* the multiply by
        ``1 / scale`` (the master-grad copy of amp O2)."""
        return _unscale(state, grads, cast_to)

    def update(self, state: LossScaleState,
               grads_finite: torch.Tensor) -> LossScaleState:
        """The reference's branch-free scale update."""
        grew = state.unskipped + 1 >= self.growth_interval
        scale_if_finite = torch.where(
            grew, torch.clamp(state.loss_scale * self.growth_factor,
                              max=self.max_scale), state.loss_scale)
        unskipped_if_finite = torch.where(
            grew, torch.zeros_like(state.unskipped), state.unskipped + 1)
        new_scale = torch.where(
            grads_finite, scale_if_finite,
            torch.clamp(state.loss_scale * self.backoff_factor,
                        min=self.min_scale))
        new_unskipped = torch.where(grads_finite, unskipped_if_finite,
                                    torch.zeros_like(state.unskipped))
        return LossScaleState(loss_scale=new_scale,
                              unskipped=new_unskipped.to(torch.int32))


class StaticLossScale:
    """Constant loss scale with the :class:`DynamicLossScale` protocol."""

    def __init__(self, scale: float = 1.0):
        self.init_scale = float(scale)

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.init_scale == other.init_scale)

    def __hash__(self):
        return hash((type(self), self.init_scale))

    def init(self, device="cuda") -> LossScaleState:
        return _init_state(self.init_scale, device)

    def scale(self, state: LossScaleState, tree: Any) -> Any:
        return _scale(state, tree)

    def unscale(self, state: LossScaleState, grads: Any,
                cast_to: torch.dtype = torch.float32) -> Any:
        return _unscale(state, grads, cast_to)

    def update(self, state: LossScaleState,
               grads_finite: torch.Tensor) -> LossScaleState:
        return state


class NoOpLossScale(StaticLossScale):
    """Scale of 1 and no overflow checking cost beyond the finite flag."""

    def __init__(self):
        super().__init__(scale=1.0)


def make_loss_scale(spec: Union[None, float, str],
                    **kwargs) -> Union[DynamicLossScale, StaticLossScale]:
    """Resolve a loss-scale spec: ``"dynamic"``, a positive float, or
    ``None`` (no scaling)."""
    if spec is None:
        return NoOpLossScale()
    if spec == "dynamic":
        return DynamicLossScale(**kwargs)
    scale = float(spec)
    if scale <= 0.0:
        raise ValueError(f"loss scale must be positive, got {scale}")
    return StaticLossScale(scale=scale)
