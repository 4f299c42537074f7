"""O1 per-op cast lists and their patching.

Counterpart of ``apex_tpu/amp/lists.py``: under :func:`o1_context` each
registered function (a module attribute) is swapped for a wrapper that
casts its floating tensor arguments, cast-to-half for the matmul and conv
class, cast-to-fp32 for the numerically sensitive class, promotion to the
widest input dtype for the mixed-input class, and every attribute is
restored on exit, nested contexts included. :func:`disable_casts` runs the
wrappers' originals inside a context. Python scalars keep their default
promotion: only tensors are cast, and the output dtype is whatever the op
makes of its cast inputs.

The default tables are the reference's, translated to torch names:

- half: ``torch.matmul``, ``dot``, ``vdot``, ``inner``, ``tensordot``,
  ``einsum``, and ``F.conv2d`` for ``jax.lax.conv_general_dilated``
  (``jax.lax.dot_general`` has no torch function of its own: its uses
  are ``torch.matmul``/``tensordot``/``einsum`` here);
- fp32: ``torch.exp``, ``expm1``, ``log``, ``log10``, ``log1p``,
  ``log2``, ``pow`` (``jnp.power``), ``cosh``, ``sinh``, ``sum``,
  ``prod``, ``cumsum``, ``cumprod``, ``torch.linalg.norm``,
  ``F.softmax``, ``F.log_softmax``, ``F.softplus`` and ``torch.erf``;
- promote: ``torch.add``, ``sub``, ``mul``, ``true_divide``, ``eq``,
  ``cat`` and ``stack`` (``jnp.subtract``, ``multiply``, ``equal``,
  ``concatenate``).

Tensor methods and operators (``x @ y``, ``x.sum()``) are not patched,
as the reference leaves the array methods alone.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves, tree_map

__all__ = ["register_half_function", "register_float_function",
           "register_promote_function", "o1_context", "disable_casts",
           "casts_are_enabled"]

_MATH = "half"
_FP32 = "float"
_PROMOTE = "promote"

# (module, attribute name, category); user registrations extend it
_REGISTRY: List[Tuple[Any, str, str]] = []
_DEFAULTS_BUILT = False
_state = threading.local()


def _cast_enabled() -> bool:
    return getattr(_state, "enabled", True)


def casts_are_enabled() -> bool:
    """False inside :func:`disable_casts`."""
    return _cast_enabled()


def _is_float(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _cast_tree_to(tree: Any, dtype: torch.dtype) -> Any:
    return tree_map(lambda x: x.to(dtype) if _is_float(x) else x, tree)


def _widest_float(tree: Any):
    widest = None
    for leaf in tree_leaves(tree):
        if _is_float(leaf):
            widest = leaf.dtype if widest is None else torch.promote_types(
                widest, leaf.dtype)
    return widest


def _wrap(fn: Callable, category: str, half_dtype: torch.dtype) -> Callable:
    """Cast the floating tensor arguments, then call ``fn``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _cast_enabled():
            return fn(*args, **kwargs)
        if category == _MATH:
            target = half_dtype
        elif category == _FP32:
            target = torch.float32
        else:  # promote: the widest floating dtype among the inputs
            target = _widest_float((args, kwargs))
        if target is not None:
            args, kwargs = _cast_tree_to((args, kwargs), target)
        return fn(*args, **kwargs)

    wrapped.__amp_wrapped__ = fn
    return wrapped


def register_half_function(module: Any, name: str) -> None:
    """Run ``module.<name>`` in the half dtype under :func:`o1_context`."""
    _REGISTRY.append((module, name, _MATH))


def register_float_function(module: Any, name: str) -> None:
    """Run ``module.<name>`` in fp32 under :func:`o1_context`."""
    _REGISTRY.append((module, name, _FP32))


def register_promote_function(module: Any, name: str) -> None:
    """Promote mixed inputs of ``module.<name>`` to the widest float
    dtype under :func:`o1_context`."""
    _REGISTRY.append((module, name, _PROMOTE))


def _build_default_registry() -> None:
    global _DEFAULTS_BUILT
    if _DEFAULTS_BUILT:
        return
    _DEFAULTS_BUILT = True
    for name in ("matmul", "dot", "vdot", "inner", "tensordot", "einsum"):
        register_half_function(torch, name)
    register_half_function(F, "conv2d")
    for name in ("exp", "expm1", "log", "log10", "log1p", "log2", "pow",
                 "cosh", "sinh", "sum", "prod", "cumsum", "cumprod"):
        register_float_function(torch, name)
    register_float_function(torch.linalg, "norm")
    for name in ("softmax", "log_softmax", "softplus"):
        register_float_function(F, name)
    register_float_function(torch, "erf")
    for name in ("add", "sub", "mul", "true_divide", "eq", "cat", "stack"):
        register_promote_function(torch, name)


@contextlib.contextmanager
def o1_context(half_dtype: torch.dtype = torch.bfloat16):
    """Patch the registered functions with their cast wrappers for the
    duration of the context; on exit every attribute is restored. A
    context opened inside another leaves the outer wrappers in place."""
    _build_default_registry()
    originals = []
    try:
        for module, name, category in _REGISTRY:
            fn = getattr(module, name)
            if hasattr(fn, "__amp_wrapped__"):
                continue  # already patched (nested contexts)
            originals.append((module, name, fn))
            setattr(module, name, _wrap(fn, category, half_dtype))
        yield
    finally:
        for module, name, fn in reversed(originals):
            setattr(module, name, fn)


@contextlib.contextmanager
def disable_casts():
    """Run everything un-cast inside an :func:`o1_context`."""
    prev = _cast_enabled()
    _state.enabled = False
    try:
        yield
    finally:
        _state.enabled = prev
