"""Megatron-style model-parallel toolkit of the port (tp=1 in this slice)."""

from apex_tpu_torch.transformer import tensor_parallel  # noqa: F401

__all__ = ["tensor_parallel"]
