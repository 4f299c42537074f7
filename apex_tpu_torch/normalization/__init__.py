"""Normalization layers of the port."""

from apex_tpu_torch.normalization.fused_layer_norm import (
    fused_layer_norm_affine)

__all__ = ["fused_layer_norm_affine"]
