"""Megatron-style model-parallel toolkit of the port at one device: the
tp=1 layers, RNG tracker and vocab-parallel cross-entropy, the grad
scaler, the fused scale-mask softmax (also as ``functional``, as the
reference aliases it) and the enums. ``parallel_state``,
``pipeline_parallel``, ``context_parallel`` and ``expert_parallel`` come
with multi-GPU (queue item A5)."""

from apex_tpu_torch.transformer import amp, tensor_parallel  # noqa: F401
from apex_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType, AttnType, LayerType, ModelType)
from apex_tpu_torch.ops.fused_softmax import FusedScaleMaskSoftmax  # noqa: F401

# the `functional` namespace (reference:apex/transformer/functional)
from apex_tpu_torch.ops import fused_softmax as functional  # noqa: F401

__all__ = ["amp", "functional", "tensor_parallel", "AttnMaskType",
           "AttnType", "LayerType", "ModelType", "FusedScaleMaskSoftmax"]
