"""Ops of the port: flash attention (forward and backward) and KV-cache
decode attention over a dense or a paged cache, each backed by hand-written
CUDA kernels on the card; the attention modules over them (self and
encoder-decoder, with the fused pre-LayerNorm + residual); inverted
dropout; softmax cross-entropy; the fused scale-mask softmax; the MLP and
fused dense layers; the sigmoid focal loss, the fused conv ops (cuDNN) and
the RNN-T transducer joint and loss."""

from apex_tpu_torch.ops.conv_fusion import (  # noqa: F401
    conv_bias, conv_bias_mask_relu, conv_bias_relu,
    conv_frozen_scale_bias_relu)
from apex_tpu_torch.ops.dropout import dropout  # noqa: F401
from apex_tpu_torch.ops.flash_attention import (  # noqa: F401
    decode_attention, dropout_keep_mask, flash_attention, mha_reference,
    paged_decode_attention, supports_flash, supports_paged)
from apex_tpu_torch.ops.focal_loss import FocalLoss, focal_loss  # noqa: F401
from apex_tpu_torch.ops.fused_softmax import (  # noqa: F401
    AttnMaskType, FusedScaleMaskSoftmax, scaled_masked_softmax,
    scaled_upper_triang_masked_softmax)
from apex_tpu_torch.ops.mlp import (  # noqa: F401
    MLP, FusedDense, FusedDenseGeluDense, fused_dense,
    fused_dense_gelu_dense, mlp_forward)
from apex_tpu_torch.ops.multihead_attn import (  # noqa: F401
    EncdecMultiheadAttn, SelfMultiheadAttn)
from apex_tpu_torch.ops.transducer import (  # noqa: F401
    TransducerJoint, TransducerLoss, transducer_joint, transducer_loss)
from apex_tpu_torch.ops.xentropy import (  # noqa: F401
    SoftmaxCrossEntropyLoss, softmax_cross_entropy_loss)

__all__ = [
    "flash_attention", "mha_reference", "supports_flash", "supports_paged",
    "decode_attention", "paged_decode_attention", "dropout_keep_mask",
    "dropout",
    "AttnMaskType", "FusedScaleMaskSoftmax", "scaled_masked_softmax",
    "scaled_upper_triang_masked_softmax",
    "MLP", "FusedDense", "FusedDenseGeluDense", "fused_dense",
    "fused_dense_gelu_dense", "mlp_forward",
    "SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss",
    "SelfMultiheadAttn", "EncdecMultiheadAttn",
    "FocalLoss", "focal_loss",
    "TransducerJoint", "TransducerLoss", "transducer_joint",
    "transducer_loss",
    "conv_bias", "conv_bias_relu", "conv_bias_mask_relu",
    "conv_frozen_scale_bias_relu",
]
