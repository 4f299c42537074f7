"""Batched tensor-list math over trees of tensors (see the package
docstring).

Counterpart of ``apex_tpu/multi_tensor_apply/multi_tensor_apply.py``.
Trees are ``dict``/``list``/``tuple`` nests of tensors
(:mod:`torch.utils._pytree`, whose dicts keep their insertion order where
JAX sorts the keys). Every norm and blend runs in fp32 whatever the
leaves' dtype, as the reference's kernels do, and on the leaves' device:
nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from apex_tpu_torch.amp.scaler import all_finite

__all__ = [
    "flatten", "unflatten", "multi_tensor_scale", "multi_tensor_axpby",
    "multi_tensor_l2norm", "multi_tensor_applier",
    "tree_global_norm", "tree_per_tensor_norms", "tensor_norms",
]


def flatten(tree: Any) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """Pack a tree into one 1-D buffer and return it with its inverse
    (``apex_C.flatten``), with ``jax.flatten_util.ravel_pytree``'s
    semantics: leaves of one dtype keep it, and the inverse then takes a
    buffer of any dtype and returns views of it; leaves of mixed dtypes
    promote to their common dtype (``torch.promote_types``, JAX's result
    type for these pairs), and the inverse casts each leaf back and
    raises ``TypeError`` on a buffer of another dtype. An empty tree
    gives an empty fp32 buffer."""
    leaves, spec = tree_flatten(tree)
    if not leaves:
        return (torch.zeros(0, dtype=torch.float32),
                lambda flat: tree_unflatten([], spec))
    shapes = [tuple(leaf.shape) for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    from_dtypes = [leaf.dtype for leaf in leaves]
    to_dtype = from_dtypes[0]
    for dt in from_dtypes[1:]:
        to_dtype = torch.promote_types(to_dtype, dt)
    flat = torch.cat([leaf.reshape(-1).to(to_dtype) for leaf in leaves])
    mixed = any(dt != to_dtype for dt in from_dtypes)

    def unravel(buf: torch.Tensor) -> Any:
        if mixed and buf.dtype != to_dtype:
            raise TypeError(f"unravel function given array of dtype "
                            f"{buf.dtype}, but expected dtype {to_dtype}")
        parts = torch.split(buf, sizes)
        out = [p.reshape(s) for p, s in zip(parts, shapes)]
        if mixed:
            out = [o.to(dt) for o, dt in zip(out, from_dtypes)]
        return tree_unflatten(out, spec)

    return flat, unravel


def unflatten(flat: torch.Tensor,
              unravel: Callable[[torch.Tensor], Any]) -> Any:
    """Inverse of :func:`flatten` (``apex_C.unflatten``)."""
    return unravel(flat)


def _float_leaves(tree: Any) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree)
            if isinstance(x, torch.Tensor) and x.is_floating_point()]


def multi_tensor_scale(tree: Any, scale: Any) -> Tuple[Any, torch.Tensor]:
    """``out = in * scale`` over every floating leaf (in fp32, cast back to
    the leaf's dtype; other leaves pass through), with the flag that every
    *output* element is finite (``amp_C.multi_tensor_scale``). ``scale``
    may be a 0-d tensor, such as ``1 / loss_scale``."""
    scale = torch.as_tensor(scale, dtype=torch.float32)

    def one(x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        return (x.to(torch.float32) * scale).to(x.dtype)

    out = tree_map(one, tree)
    return out, all_finite(out, observe=None)


def multi_tensor_axpby(a: Any, x_tree: Any, b: Any, y_tree: Any,
                       out_dtype: Any = None) -> Tuple[Any, torch.Tensor]:
    """``out = a * x + b * y`` leaf by leaf in fp32, cast to ``out_dtype``
    (default each ``x`` leaf's dtype), with the finite flag of the outputs
    (``amp_C.multi_tensor_axpby``)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)

    def one(x, y):
        out = a * x.to(torch.float32) + b * y.to(torch.float32)
        return out.to(out_dtype or x.dtype)

    out = tree_map(one, x_tree, y_tree)
    return out, all_finite(out, observe=None)


def tree_per_tensor_norms(tree: Any, ord: int = 2) -> Any:
    """Each leaf's L2 norm (L-inf with ``ord=0``) as an fp32 0-d tensor, in
    the tree's structure."""
    def one(x):
        x = x.to(torch.float32)
        if ord == 0:
            return torch.max(torch.abs(x))
        return torch.sqrt(torch.sum(x * x))

    return tree_map(one, tree)


def tensor_norms(tensors: List[torch.Tensor], ord: int = 2) -> torch.Tensor:
    """The L2 norms (L-inf with ``ord=0``) of a list of fp32 tensors as
    one fp32 vector, the per-tensor norms of LAMB, NovoGrad and LARC. On
    CUDA one ``torch._foreach_norm`` pass. Elsewhere an L2 norm is
    ``sqrt(sum(x * x))`` a tensor, the reference's form: the CPU's
    ``torch.linalg.vector_norm`` (and so ``_foreach_norm``) accumulates
    fp32 over long runs and loses accuracy on tensors of millions of
    elements, where ``torch.sum``'s cascade does not."""
    if ord == 0:
        return torch.stack(torch._foreach_norm(tensors, float("inf")))
    if tensors and tensors[0].is_cuda:
        return torch.stack(torch._foreach_norm(tensors))
    return torch.sqrt(torch.stack([torch.sum(x * x) for x in tensors]))


def tree_global_norm(tree: Any) -> torch.Tensor:
    """The global L2 norm over every floating leaf, each squared and summed
    in fp32 (``amp_C.multi_tensor_l2norm``'s global output, LAMB's clip
    norm). An empty tree gives a CPU fp32 zero."""
    leaves = _float_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = [torch.sum(x.to(torch.float32) ** 2) for x in leaves]
    return torch.sqrt(torch.stack(sq).sum())


def multi_tensor_l2norm(tree: Any, per_tensor: bool = False):
    """The global norm, or ``(global norm, per-tensor norms)`` with
    ``per_tensor=True`` (the binding's optional second output)."""
    g = tree_global_norm(tree)
    if per_tensor:
        return g, tree_per_tensor_norms(tree)
    return g


class _MultiTensorApplier:
    """``multi_tensor_applier(op, noop_flag, tensor_lists, *args)`` call
    sites: calls ``op(*tensor_lists, *args)`` and returns its result. It
    serves functional ops taking one positional argument per tensor list;
    the reference's in-place ``amp_C`` call shapes (an output list written
    into) have no counterpart: call :func:`multi_tensor_scale`,
    :func:`multi_tensor_axpby` or :func:`multi_tensor_l2norm`, which return
    their outputs."""

    available = True

    def __call__(self, op, noop_flag_unused, tensor_lists, *args):
        return op(*tensor_lists, *args)


multi_tensor_applier = _MultiTensorApplier()
