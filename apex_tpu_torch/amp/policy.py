"""Mixed-precision policies: apex.amp's opt levels as three dtypes.

Counterpart of ``apex_tpu/amp/policy.py``. A :class:`Policy` is a param,
a compute and an output dtype plus two flags, applied by casting the
floating leaves of a tree at well-defined boundaries: params and inputs to
the compute dtype at use (:func:`cast_to_compute`, :func:`with_policy`),
outputs to the output dtype. "Master weights" (O2) are params stored in
fp32 and cast at use. Dtypes are ``torch.dtype``; the default half dtype is
``torch.bfloat16``, and float16 presets turn on dynamic loss scaling, as
in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch
from torch.utils._pytree import tree_map

__all__ = ["Policy", "O0", "O1", "O2", "O3", "get_policy",
           "cast_to_compute", "cast_to_param", "cast_to_output",
           "cast_floating", "with_policy"]


def _is_float(x: Any) -> bool:
    # non-floating leaves (ints, bools, generators) pass through casts
    return isinstance(x, torch.Tensor) and x.is_floating_point()


@dataclasses.dataclass(frozen=True)
class Policy:
    """A mixed-precision policy.

    Attributes:
      name: display name ("O0".."O3" or custom).
      param_dtype: dtype parameters (and optimizer state) are stored in.
      compute_dtype: dtype matmuls and convs run in.
      output_dtype: dtype of model outputs (losses accumulate in fp32).
      keep_norms_fp32: norms' reductions and params in fp32
        (``keep_batchnorm_fp32``).
      loss_scale: None (no scaling), a float (static), or "dynamic".
    """

    name: str = "O0"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    keep_norms_fp32: bool = True
    loss_scale: Union[None, float, str] = None

    @property
    def uses_master_weights(self) -> bool:
        """True when params are stored wider than compute (O2)."""
        return self.param_dtype != self.compute_dtype

    @property
    def uses_dynamic_scaling(self) -> bool:
        return self.loss_scale == "dynamic"

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)


def _half_scale(half_dtype: torch.dtype):
    return "dynamic" if half_dtype == torch.float16 else None


def O0() -> Policy:
    """Pure fp32."""
    return Policy(name="O0", param_dtype=torch.float32,
                  compute_dtype=torch.float32, output_dtype=torch.float32,
                  keep_norms_fp32=True, loss_scale=None)


def O1(half_dtype: torch.dtype = torch.bfloat16) -> Policy:
    """Op-level mixed precision: fp32 params, matmul-class ops in half;
    float16 pairs with dynamic loss scaling."""
    return Policy(name="O1", param_dtype=torch.float32,
                  compute_dtype=half_dtype, output_dtype=torch.float32,
                  keep_norms_fp32=True, loss_scale=_half_scale(half_dtype))


def O2(half_dtype: torch.dtype = torch.bfloat16) -> Policy:
    """"Almost half": fp32 master params, compute and outputs in half,
    norms in fp32."""
    return Policy(name="O2", param_dtype=torch.float32,
                  compute_dtype=half_dtype, output_dtype=half_dtype,
                  keep_norms_fp32=True, loss_scale=_half_scale(half_dtype))


def O3(half_dtype: torch.dtype = torch.bfloat16) -> Policy:
    """Pure half, the speed baseline."""
    return Policy(name="O3", param_dtype=half_dtype, compute_dtype=half_dtype,
                  output_dtype=half_dtype, keep_norms_fp32=False,
                  loss_scale=None)


_OPT_LEVELS: dict = {"O0": O0, "O1": O1, "O2": O2, "O3": O3}


def get_policy(opt_level: Union[str, Policy],
               half_dtype: torch.dtype = torch.bfloat16,
               **overrides) -> Policy:
    """Resolve an opt-level string (or a :class:`Policy`) and apply keyword
    overrides, which win over the preset."""
    if isinstance(opt_level, Policy):
        pol = opt_level
    else:
        try:
            factory = _OPT_LEVELS[opt_level.upper()]
        except KeyError:
            raise ValueError(
                f"Unexpected optimization level {opt_level!r}; options are "
                "'O0', 'O1', 'O2', 'O3'.") from None
        pol = factory() if opt_level.upper() == "O0" else factory(half_dtype)
    if overrides:
        pol = pol.replace(**overrides)
    return pol


def _cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    return tree_map(lambda x: x.to(dtype) if _is_float(x) else x, tree)


def cast_to_compute(tree: Any, policy: Policy) -> Any:
    """Float leaves to the compute dtype (the use-site cast)."""
    return _cast_tree(tree, policy.compute_dtype)


def cast_to_param(tree: Any, policy: Policy) -> Any:
    """Float leaves to the param dtype (e.g. grads before the update)."""
    return _cast_tree(tree, policy.param_dtype)


def cast_to_output(tree: Any, policy: Policy) -> Any:
    """Float leaves to the output dtype."""
    return _cast_tree(tree, policy.output_dtype)


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Float leaves to ``dtype`` (``network_to_half``/``convert_network``
    on a tree). A leaf already of ``dtype`` is returned as it is, not
    copied."""
    return _cast_tree(tree, dtype)


def with_policy(fn: Callable, policy: Policy,
                cast_inputs: bool = True) -> Callable:
    """Wrap a functional apply ``fn(params, *args, **kwargs)``: params (and
    inputs) to the compute dtype, outputs to the output dtype. For a
    module, ``fn`` is ``lambda p, *a: torch.func.functional_call(model, p,
    a)``."""

    def wrapped(params, *args, **kwargs):
        params = cast_to_compute(params, policy)
        if cast_inputs:
            args = cast_to_compute(args, policy)
            kwargs = cast_to_compute(kwargs, policy)
        out = fn(params, *args, **kwargs)
        return cast_to_output(out, policy)

    return wrapped
