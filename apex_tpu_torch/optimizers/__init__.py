"""Fused optimizers of the port (FusedAdam in this slice)."""

from apex_tpu_torch.optimizers._base import OptimizerBase  # noqa: F401
from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    AdamState, FusedAdam)

__all__ = ["OptimizerBase", "FusedAdam", "AdamState"]
