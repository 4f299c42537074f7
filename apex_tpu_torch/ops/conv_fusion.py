"""Conv + bias (+ ReLU, mask, frozen scale and bias) ops, the counterpart
of ``apex_tpu/ops/conv_fusion.py``.

Reference: ``reference:apex/contrib/conv_bias_relu/`` (``ConvBiasReLU``,
``ConvBias``, ``ConvBiasMaskReLU``, ``ConvFrozenScaleBiasReLU`` over
cuDNN-frontend fusion graphs). The JAX package leaves each to XLA, which
folds the epilogue into the convolution; the port runs the conv on cuDNN
(``F.conv2d`` on the card) over channels-last views, as
:mod:`apex_tpu_torch.models.resnet` does, and the epilogue as torch ops.

The API is the reference's: NHWC input, HWIO weight, a symmetric integer
padding and one stride for both axes; NHWC output. The weight is cast to
the input's dtype, and the bias and scale are applied in the input's
dtype, not in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv_bias", "conv_bias_relu", "conv_bias_mask_relu",
           "conv_frozen_scale_bias_relu"]


def _conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
                 padding: int) -> torch.Tensor:
    """NHWC ``x`` by HWIO ``w``: cuDNN on the NCHW view with channels-last
    strides, the result viewed back as NHWC."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    out = F.conv2d(xc, wc, stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def conv_bias(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``ConvBias``: NHWC conv + per-channel bias."""
    return _conv2d_nhwc(x, weight, stride, padding) + bias.to(x.dtype)


def conv_bias_relu(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, stride: int = 1,
                   padding: int = 0) -> torch.Tensor:
    """``ConvBiasReLU``: conv + bias + ReLU."""
    return torch.relu(conv_bias(x, weight, bias, stride, padding))


def conv_bias_mask_relu(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, mask: torch.Tensor,
                        stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``ConvBiasMaskReLU``: conv + bias, times an elementwise mask, then
    ReLU."""
    return torch.relu(conv_bias(x, weight, bias, stride, padding)
                      * mask.to(x.dtype))


def conv_frozen_scale_bias_relu(x: torch.Tensor, weight: torch.Tensor,
                                scale: torch.Tensor, bias: torch.Tensor,
                                stride: int = 1, padding: int = 0
                                ) -> torch.Tensor:
    """``ConvFrozenScaleBiasReLU``: conv, then a frozen batch norm's
    per-channel scale and bias, then ReLU."""
    out = _conv2d_nhwc(x, weight, stride, padding)
    return torch.relu(out * scale.to(x.dtype) + bias.to(x.dtype))
