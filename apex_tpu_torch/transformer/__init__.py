"""Megatron-style model-parallel toolkit of the port: tensor
parallelism (the mappings, the sharded layers, the ring collective
matmuls, the RNG tracker and vocab-parallel cross-entropy), the
sequence-parallel regions of ``context_parallel``, the grad scaler, the
fused scale-mask softmax (also as ``functional``, as the reference
aliases it), the enums, and ``parallel_state``, the process groups of the
(pipe, data, context, tensor) mesh, and ``pipeline_parallel``, the
schedules, stage hops and microbatch calculators (its names resolve on
first access), context parallelism's ring and Ulysses attention
(``context_parallel``) and ``expert_parallel``, the expert-sharded MoE
MLP."""

from apex_tpu_torch.transformer import (  # noqa: F401
    amp, context_parallel, expert_parallel, parallel_state,
    pipeline_parallel, tensor_parallel)
from apex_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType, AttnType, LayerType, ModelType)
from apex_tpu_torch.ops.fused_softmax import FusedScaleMaskSoftmax  # noqa: F401

# the `functional` namespace (reference:apex/transformer/functional)
from apex_tpu_torch.ops import fused_softmax as functional  # noqa: F401

__all__ = ["amp", "context_parallel", "expert_parallel", "functional",
           "parallel_state",
           "pipeline_parallel", "tensor_parallel", "AttnMaskType", "AttnType", "LayerType",
           "ModelType", "FusedScaleMaskSoftmax"]
