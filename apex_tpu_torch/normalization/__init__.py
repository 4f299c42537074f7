"""Normalization layers of the port: fused LayerNorm and RMSNorm, the
functions and the modules, on the ``ln_fwd``/``ln_bwd`` CUDA kernels."""

from apex_tpu_torch.normalization.fused_layer_norm import (  # noqa: F401
    FusedLayerNorm, FusedRMSNorm, MixedFusedLayerNorm, MixedFusedRMSNorm,
    fused_layer_norm, fused_layer_norm_affine, fused_rms_norm,
    fused_rms_norm_affine, mixed_dtype_fused_layer_norm_affine,
    mixed_dtype_fused_rms_norm_affine)

__all__ = [
    "fused_layer_norm", "fused_layer_norm_affine",
    "fused_rms_norm", "fused_rms_norm_affine",
    "mixed_dtype_fused_layer_norm_affine", "mixed_dtype_fused_rms_norm_affine",
    "FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
    "MixedFusedRMSNorm",
]
