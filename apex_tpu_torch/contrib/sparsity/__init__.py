"""ASP: automatic structured (2:4) sparsity, the counterpart of
``apex_tpu/contrib/sparsity``.

Reference: ``reference:apex/contrib/sparsity/asp.py:28-44`` and the mask
pattern library ``sparse_masklib.py``.
"""

from apex_tpu_torch.contrib.sparsity.asp import (  # noqa: F401
    ASP, apply_masks, compute_sparse_masks, mn_1d_mask,
    sparse_parameter_paths)

__all__ = ["ASP", "compute_sparse_masks", "apply_masks", "mn_1d_mask",
           "sparse_parameter_paths"]
