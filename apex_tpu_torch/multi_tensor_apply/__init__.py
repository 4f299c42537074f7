"""Tensor-list ops of the port: ``amp_C``'s ``multi_tensor_*`` over trees
of tensors.

Counterpart of ``apex_tpu/multi_tensor_apply/``. The reference batches an
elementwise op over a list of tensors with a chunked launcher; here each
op runs as ``torch`` calls over the tree (``torch._foreach_*`` where one
pass over the list does it), and the ``noop_flag`` overflow buffer
becomes a returned boolean 0-d tensor: the ops the reference guards with
the flag return ``(result, all_finite)``, so a caller skips a step with
:func:`apex_tpu_torch.amp.select_tree` and no host read.
"""

from apex_tpu_torch.multi_tensor_apply.multi_tensor_apply import (  # noqa: F401
    flatten,
    multi_tensor_applier,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
    tensor_norms,
    tree_global_norm,
    tree_per_tensor_norms,
    unflatten,
)

__all__ = [
    "flatten",
    "unflatten",
    "multi_tensor_scale",
    "multi_tensor_axpby",
    "multi_tensor_l2norm",
    "multi_tensor_applier",
    "tree_global_norm",
    "tree_per_tensor_norms",
    "tensor_norms",
]
