"""ResNet-50 for the port: the amp and data-parallel headline model.

Counterpart of ``apex_tpu/models/resnet.py`` (ResNet v1.5, the stride 2
in the bottleneck's 3x3) as ``nn.Module``s whose parameter and buffer
names mirror the JAX pytree keys: ``stem.conv``, ``stem.bn.*``,
``b<i>_<j>.{conv1,conv2,conv3,conv_ds}``, ``b<i>_<j>.{bn1,bn2,bn3,bn_ds}.*``
and ``fc.{weight,bias}`` (conv weights OIHW here, HWIO there: see
:mod:`apex_tpu_torch._bridge`).

The API is NHWC, as the reference's: ``model(x)`` takes ``(n, h, w, 3)``
and returns fp32 logits ``(n, num_classes)``; in training mode every BN
updates its buffers in place, as torch's BN does. Inside, the convs run
``F.conv2d`` (cuDNN on the card) on ``x.permute(0, 3, 1, 2)``, an NCHW
view with channels-last strides, and the activations stay channels-last
throughout. Padding is XLA's ``"SAME"``, which is not torchvision's: a
stride-2 3x3 conv over an even size pads (0, 1), so it is padded with
``F.pad`` and convolved unpadded; stride 1 pads (1, 1); the stem pads 3 on
each side and the max pool pads with -inf. BN is
:class:`~apex_tpu_torch.parallel.sync_batchnorm.SyncBatchNorm` on the
channel axis, its apply at the compute dtype when that is bf16
(``bn_apply_compute_dtype``), in fp32 otherwise; the head is the fp32 mean
over the spatial axes, then ``h @ w.T + b`` in fp32. The convs, BN, pool
and head are XLA work in the reference: no Pallas kernel, so no hand
kernel here either.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["ResNetConfig", "ResNet50", "Bottleneck"]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # resnet-50
    width: int = 64
    compute_dtype: torch.dtype = torch.bfloat16
    params_dtype: torch.dtype = torch.float32
    bn_axis_name: Optional[str] = None  # "data": BN statistics across ranks
    bn_momentum: float = 0.1
    # the BN normalize at compute precision when that is bf16 (statistics
    # stay fp32); fp16 keeps the fp32 apply, keep_batchnorm_fp32's case
    bn_apply_compute_dtype: bool = True
    # the MLPerf conv0 reformulation: 2x2 spatial blocks folded into
    # channels and the stem run as a 4x4 stride-1 conv, the same math
    stem_space_to_depth: bool = False


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA ``"SAME"`` padding of one spatial axis: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``"SAME"`` conv of an NCHW (channels-last) ``x`` by an OIHW ``w``
    cast to ``x``'s dtype."""
    kh, kw = w.shape[2:]
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    w = w.to(x.dtype, memory_format=torch.channels_last)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1])).contiguous(
        memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride)


def _conv_weight(o: int, i: int, k: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(o, i, k, k, dtype=dtype, device=device))


def _init_conv(w: torch.Tensor, generator: torch.Generator) -> None:
    # he/kaiming fan-out normal (torchvision's conv init)
    o, _, kh, kw = w.shape
    std = math.sqrt(2.0 / (o * kh * kw))
    with torch.no_grad():
        w.copy_(std * torch.randn(w.shape, generator=generator,
                                  dtype=torch.float32).to(w.dtype))


def _bn(cfg: ResNetConfig, n: int, device, relu: bool = True
        ) -> SyncBatchNorm:
    apply = (cfg.compute_dtype if cfg.bn_apply_compute_dtype
             and cfg.compute_dtype == torch.bfloat16 else None)
    return SyncBatchNorm(n, momentum=cfg.bn_momentum,
                         axis_name=cfg.bn_axis_name, channel_axis=1,
                         fuse_relu=relu, param_dtype=cfg.params_dtype,
                         apply_dtype=apply, device=device)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 with the residual added before the
    last BN's ReLU, and a 1x1 strided projection when the shape
    changes."""

    expansion = 4

    def __init__(self, cfg: ResNetConfig, in_ch: int, ch: int, stride: int,
                 device="cuda"):
        super().__init__()
        dt = cfg.params_dtype
        self.stride = stride
        self.out_ch = ch * self.expansion
        self.downsample = stride != 1 or in_ch != self.out_ch
        self.conv1 = _conv_weight(ch, in_ch, 1, dt, device)
        self.bn1 = _bn(cfg, ch, device)
        self.conv2 = _conv_weight(ch, ch, 3, dt, device)
        self.bn2 = _bn(cfg, ch, device)
        self.conv3 = _conv_weight(self.out_ch, ch, 1, dt, device)
        self.bn3 = _bn(cfg, self.out_ch, device)
        if self.downsample:
            self.conv_ds = _conv_weight(self.out_ch, in_ch, 1, dt, device)
            self.bn_ds = _bn(cfg, self.out_ch, device, relu=False)

    def convs(self):
        return [self.conv1, self.conv2, self.conv3] + (
            [self.conv_ds] if self.downsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(_conv(x, self.conv1))
        h = self.bn2(_conv(h, self.conv2, self.stride))
        h = _conv(h, self.conv3)
        sc = (self.bn_ds(_conv(x, self.conv_ds, self.stride))
              if self.downsample else x)
        return self.bn3(h, z=sc)


class _Stem(nn.Module):
    def __init__(self, cfg: ResNetConfig, device):
        super().__init__()
        self.conv = _conv_weight(cfg.width, 3, 7, cfg.params_dtype, device)
        self.bn = _bn(cfg, cfg.width, device)


class _Head(nn.Module):
    def __init__(self, n_in: int, n_out: int, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, dtype=dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, dtype=dtype,
                                             device=device))


class ResNet50(nn.Module):
    """NHWC ResNet v1.5 on ``device`` (default ``"cuda"``; raises when no
    card is present). Parameters are allocated, not initialized: call
    :meth:`init` with a ``torch.Generator`` or load a state dict
    (:func:`apex_tpu_torch._bridge.resnet_params_from_jax`)."""

    def __init__(self, config: ResNetConfig = ResNetConfig(),
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = config
        self.stem = _Stem(config, dev)
        self.block_names = []
        in_ch = config.width
        for i, n in enumerate(config.stage_sizes):
            ch = config.width * (2 ** i)
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                blk = Bottleneck(config, in_ch, ch, stride, dev)
                self.add_module(f"b{i}_{j}", blk)
                self.block_names.append(f"b{i}_{j}")
                in_ch = blk.out_ch
        self.feat_ch = in_ch
        self.fc = _Head(in_ch, config.num_classes, config.params_dtype, dev)

    def blocks(self):
        return [getattr(self, name) for name in self.block_names]

    def init(self, generator: torch.Generator) -> "ResNet50":
        """The reference's init law: kaiming fan-out normal convs, unit BN
        scales and zero shifts with fresh running statistics, a uniform
        ``+-1/sqrt(feat_ch)`` head weight and a zero head bias. Draws come
        from the CPU ``generator`` in a fixed order, so a seed gives the
        same weights on every device (not the JAX package's weights)."""
        _init_conv(self.stem.conv, generator)
        for blk in self.blocks():
            for w in blk.convs():
                _init_conv(w, generator)
        for m in self.modules():
            if isinstance(m, SyncBatchNorm):
                m.reset_parameters()
        bound = 1.0 / math.sqrt(self.feat_ch)
        with torch.no_grad():
            w = torch.rand(self.fc.weight.shape, generator=generator,
                           dtype=torch.float32) * (2 * bound) - bound
            self.fc.weight.copy_(w.to(self.fc.weight.dtype))
            self.fc.bias.zero_()
        return self

    def _stem_conv(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The 7x7 stride-2 stem over an NCHW (channels-last) ``x``, or its
        space-to-depth form (``stem_space_to_depth``): each tap index u in
        [0, 7) is u = 2 * ka + da - 1 with ka in [0, 4), da in {0, 1}, so
        the kernel padded to 8x8 on the low side, (da, db) folded into its
        input channels, is a 4x4 stride-1 conv over the 2x2-block-folded
        input with padding (2, 1)."""
        if not self.cfg.stem_space_to_depth:
            return F.conv2d(x, w.to(x.dtype,
                                    memory_format=torch.channels_last),
                            stride=2, padding=3)
        n, c, hh, ww = x.shape
        if hh % 2 or ww % 2:
            raise ValueError("space-to-depth stem needs even input dims")
        nhwc = x.permute(0, 2, 3, 1)
        xs = nhwc.reshape(n, hh // 2, 2, ww // 2, 2, c)
        xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(n, hh // 2, ww // 2, 4 * c)
        hwio = w.to(x.dtype).permute(2, 3, 1, 0)
        w8 = F.pad(hwio, (0, 0, 0, 0, 1, 0, 1, 0))
        w4 = w8.reshape(4, 2, 4, 2, c, w.shape[0])
        w4 = w4.permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * c, w.shape[0])
        xs = F.pad(xs.permute(0, 3, 1, 2), (2, 1, 2, 1)).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(xs, w4.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``(n, h, w, 3)`` NHWC; returns fp32 logits."""
        h = x.to(self.cfg.compute_dtype).permute(0, 3, 1, 2)
        h = h.contiguous(memory_format=torch.channels_last)
        h = self.stem.bn(self._stem_conv(self.stem.conv, h))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for blk in self.blocks():
            h = blk(h)
        h = h.to(torch.float32).mean(dim=(2, 3))
        return h @ self.fc.weight.to(torch.float32).t() + self.fc.bias
