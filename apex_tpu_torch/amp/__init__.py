"""Mixed precision for the port: policies (:class:`Policy`, the O0-O3
presets and the tree casts), the O1 per-op cast lists
(:func:`o1_context`), and on-device loss scaling with
:func:`scaled_value_and_grad`, the functional ``amp.scale_loss`` step.
See :mod:`apex_tpu_torch.fp16_utils` for the legacy-API shims."""

from apex_tpu_torch.amp.lists import (  # noqa: F401
    casts_are_enabled, disable_casts, o1_context, register_float_function,
    register_half_function, register_promote_function)
from apex_tpu_torch.amp.policy import (  # noqa: F401
    O0, O1, O2, O3, Policy, cast_floating, cast_to_compute, cast_to_output,
    cast_to_param, get_policy, with_policy)
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    DynamicLossScale, LossScaleState, NoOpLossScale, StaticLossScale,
    all_finite, make_loss_scale, scaled_value_and_grad, select_tree)

__all__ = [
    "Policy", "O0", "O1", "O2", "O3", "get_policy",
    "cast_to_compute", "cast_to_param", "cast_to_output", "cast_floating",
    "with_policy",
    "LossScaleState", "DynamicLossScale", "StaticLossScale", "NoOpLossScale",
    "make_loss_scale", "all_finite", "select_tree", "scaled_value_and_grad",
    "o1_context", "disable_casts", "casts_are_enabled",
    "register_half_function", "register_float_function",
    "register_promote_function",
]
