"""Fused optimizers of the port: FusedAdam, FusedAdagrad, FusedSGD,
FusedLAMB (and the mixed-precision LAMB over fp32 masters), FusedNovoGrad,
the LARC wrapper, the flat-buffer tier FlatOptimizer, and the ZeRO-1
optimizers DistributedFusedAdam and DistributedFusedLAMB, whose state is
sharded over the data-parallel group."""

from apex_tpu_torch.optimizers._base import (  # noqa: F401
    OptimizerBase, global_grad_norm)
from apex_tpu_torch.optimizers.distributed_fused import (  # noqa: F401
    DistributedFusedAdam, DistributedFusedLAMB, ZeroAdamState, ZeroLambState)
from apex_tpu_torch.optimizers.flat import (  # noqa: F401
    FlatOptimizer, FlatState)
from apex_tpu_torch.optimizers.fused_adam import (  # noqa: F401
    AdagradState, AdamState, FusedAdagrad, FusedAdam)
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB, FusedMixedPrecisionLamb, LAMBState, MixedPrecisionLambState)
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad, NovoGradState)
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD, SGDState  # noqa: F401
from apex_tpu_torch.optimizers.larc import (  # noqa: F401
    LARC, larc_transform_grads)

__all__ = [
    "OptimizerBase", "global_grad_norm",
    "FlatOptimizer", "FlatState",
    "FusedAdam", "AdamState",
    "FusedAdagrad", "AdagradState",
    "FusedLAMB", "LAMBState",
    "FusedMixedPrecisionLamb", "MixedPrecisionLambState",
    "FusedNovoGrad", "NovoGradState",
    "FusedSGD", "SGDState",
    "LARC", "larc_transform_grads",
    "DistributedFusedAdam", "ZeroAdamState",
    "DistributedFusedLAMB", "ZeroLambState",
]
