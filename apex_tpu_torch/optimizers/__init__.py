"""Fused optimizers of the port: FusedAdam, FusedSGD and the flat-buffer
tier FlatOptimizer."""

from apex_tpu_torch.optimizers._base import (  # noqa: F401
    OptimizerBase, global_grad_norm)
from apex_tpu_torch.optimizers.flat import (  # noqa: F401
    FlatOptimizer, FlatState)
from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    AdamState, FusedAdam)
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD, SGDState  # noqa: F401

__all__ = ["OptimizerBase", "global_grad_norm", "FusedAdam", "AdamState",
           "FusedSGD", "SGDState", "FlatOptimizer", "FlatState"]
