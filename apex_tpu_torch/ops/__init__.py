"""Ops of the port: flash attention (forward and backward) and KV-cache
decode attention over a dense or a paged cache, each backed by hand-written
CUDA kernels on the card; inverted dropout; softmax cross-entropy."""

from apex_tpu_torch.ops.flash_attention import (  # noqa: F401
    decode_attention, dropout_keep_mask, flash_attention, mha_reference,
    paged_decode_attention)
from apex_tpu_torch.ops.xentropy import (  # noqa: F401
    softmax_cross_entropy_loss)
from apex_tpu_torch.ops.dropout import dropout  # noqa: F401

__all__ = ["flash_attention", "mha_reference", "decode_attention",
           "paged_decode_attention", "dropout_keep_mask",
           "softmax_cross_entropy_loss", "dropout"]
