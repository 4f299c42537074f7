"""Attention ops of the port: flash attention and KV-cache decode
attention, each backed by a hand-written CUDA kernel on the card."""

from apex_tpu_torch.ops.flash_attention import (  # noqa: F401
    decode_attention, flash_attention, mha_reference)

__all__ = ["flash_attention", "mha_reference", "decode_attention"]
