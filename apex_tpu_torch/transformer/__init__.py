"""Megatron-style model-parallel toolkit of the port (one device: tp=1
layers and the grad scaler)."""

from apex_tpu_torch.transformer import amp, tensor_parallel  # noqa: F401

__all__ = ["amp", "tensor_parallel"]
