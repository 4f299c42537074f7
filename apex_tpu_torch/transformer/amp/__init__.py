"""Model-parallel-aware loss scaling of the port."""

from apex_tpu_torch.transformer.amp.grad_scaler import GradScaler  # noqa: F401

__all__ = ["GradScaler"]
