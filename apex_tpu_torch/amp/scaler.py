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
Every scale update records ``amp/loss_scale``, ``amp/overflow_count`` and
``amp/skipped_steps`` into an open in-step collector
(:mod:`apex_tpu_torch.observability.ingraph`); with none open it adds
nothing. :func:`scaled_value_and_grad` is the functional ``amp.scale_loss``
step. :func:`all_finite` hands the tree it checks to the numerics
watchdog (:func:`apex_tpu_torch.observability.health.observe_tree`, as
``health/grads/*`` by default), which adds nothing unless a health policy
is active and a collector is open. With ``axis_names`` (mesh axis names of
:mod:`apex_tpu_torch.transformer.parallel_state`, or process groups) the
finite flag is reduced with a MIN over each axis's group, so every rank
keeps or skips the step together; an axis that is not bound raises
``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.observability import health as _health
from apex_tpu_torch.observability import ingraph as _metrics

__all__ = ["LossScaleState", "DynamicLossScale", "StaticLossScale",
           "NoOpLossScale", "make_loss_scale", "all_finite", "select_tree",
           "scaled_value_and_grad"]


class LossScaleState(NamedTuple):
    """Carried scaler state: ``(loss_scale, unskipped_steps)``."""

    loss_scale: torch.Tensor  # fp32 0-d
    unskipped: torch.Tensor   # int32 0-d


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _axis_list(axis_names) -> tuple:
    if not axis_names:
        return ()
    if isinstance(axis_names, (str, torch.distributed.ProcessGroup)):
        return (axis_names,)
    return tuple(axis_names)


def all_finite(tree: Any,
               axis_names: Union[None, str, Sequence[str]] = None,
               observe: Optional[str] = "grads") -> torch.Tensor:
    """One boolean 0-d tensor: every floating leaf of ``tree`` is finite
    (the reference's fused finite-check; no host sync), reduced with a
    MIN over the groups of ``axis_names`` when given.

    ``observe`` names the tree for the health watchdog: the amp grad
    check's default ``"grads"`` gives an overflow step its per-leaf
    attribution (``health/grads/*``). A caller checking a tree that is not
    the gradients (``multi_tensor_apply``'s outputs) passes another name
    or None, or its records would sum into, and misattribute,
    ``health/grads/*``."""
    if observe is not None:
        _health.observe_tree(tree, observe)
    axes = _axis_list(axis_names)
    if axes:
        from apex_tpu_torch.transformer.parallel_state import resolve_axis
        groups = [resolve_axis(ax) for ax in axes]
    leaves = [x for x in tree_leaves(tree) if _is_float(x)]
    if not leaves:
        finite = torch.tensor(True)
    else:
        finite = torch.stack([torch.isfinite(x).all() for x in leaves]).all()
    if axes:
        flag = finite.to(torch.int32)
        for group in groups:
            torch.distributed.all_reduce(
                flag, op=torch.distributed.ReduceOp.MIN, group=group)
        finite = flag.to(torch.bool)
    return finite


def select_tree(pred: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """``torch.where(pred, ...)`` over matching trees: the on-device skip."""
    return tree_map(lambda t, f: torch.where(pred, torch.as_tensor(t),
                                             torch.as_tensor(f)),
                    on_true, on_false)


def _record_scale_metrics(scale: torch.Tensor,
                          grads_finite: torch.Tensor) -> None:
    """Telemetry of every scale update, the reference's replacement for
    apex's overflow print. Thunked: with no collector open this adds no
    aten call."""
    _metrics.record("amp/loss_scale", lambda: scale.to(torch.float32),
                    reduce="mean")
    overflowed = lambda: 1.0 - grads_finite.to(torch.float32)  # noqa: E731
    _metrics.record("amp/overflow_count", overflowed, reduce="sum")
    # the skip is the whole optimizer step, so per step these coincide;
    # separate series because static scaling skips without backing off
    _metrics.record("amp/skipped_steps", overflowed, reduce="max")


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
    """The reference's ``unscale``: each float leaf rounded to ``cast_to``,
    then multiplied by the fp32 ``1 / scale`` in their promoted dtype, as
    JAX promotes ``g.astype(cast_to) * inv`` (a bf16 or fp16 ``cast_to``
    gives fp32 grads). Non-float leaves pass through untouched."""
    inv = 1.0 / state.loss_scale

    def one(g):
        if not _is_float(g):
            return g
        wide = torch.promote_types(cast_to, inv.dtype)
        return g.to(cast_to).to(wide) * inv.to(wide)

    return tree_map(one, grads)


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
        """Grads cast to ``cast_to`` *before* the multiply by ``1 /
        scale`` (the master-grad copy of amp O2). The product is taken in
        ``promote_types(cast_to, fp32)``, as the reference's is: a bf16 or
        fp16 ``cast_to`` rounds the grads there and returns them in fp32."""
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
        _record_scale_metrics(new_scale, grads_finite)
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
        _record_scale_metrics(state.loss_scale, grads_finite)
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


def scaled_value_and_grad(
    fun: Callable,
    loss_scale: Union[DynamicLossScale, StaticLossScale],
    has_aux: bool = False,
    axis_names: Union[None, str, Sequence[str]] = None,
    grad_dtype: torch.dtype = torch.float32,
):
    """The functional ``with amp.scale_loss(...) as scaled:
    scaled.backward()``.

    Returns ``step(state, params, *args, **kwargs) -> (value, aux, grads,
    grads_finite, new_state)``. ``params`` is a tree of leaf tensors that
    require grad (``dict(model.named_parameters())``, read by ``fun``
    directly or through ``torch.func.functional_call``); ``fun(params,
    *args, **kwargs)`` returns the loss, or ``(loss, aux)`` with
    ``has_aux``. The grads are ``torch.autograd.grad`` of ``value.float() *
    loss_scale``, unscaled into ``grad_dtype`` (the "master" grads), in
    the tree of ``params`` (zeros for a parameter the loss does not read,
    as JAX returns); nothing accumulates into ``.grad``. ``new_state`` has
    the scale already updated; ``grads_finite`` is reduced over
    ``axis_names`` (:func:`all_finite`). Gate the optimizer on
    ``grads_finite`` (``OptimizerBase.step(..., grads_finite=)``).
    """

    def step(state: LossScaleState, params: Any, *args, **kwargs):
        out = fun(params, *args, **kwargs)
        value, aux = out if has_aux else (out, None)
        scaled = value.to(torch.float32) * state.loss_scale
        leaves, spec = tree_flatten(params)
        grads = torch.autograd.grad(scaled, leaves, allow_unused=True,
                                    materialize_grads=True)
        grads = loss_scale.unscale(state, tree_unflatten(list(grads), spec),
                                   cast_to=grad_dtype)
        finite = all_finite(grads, axis_names=axis_names)
        new_state = loss_scale.update(state, finite)
        aux = tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor)
                       else x, aux)
        return value.detach(), aux, grads, finite, new_state

    return step
