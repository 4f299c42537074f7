"""Batch normalization with the reference's arithmetic, on one device.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py``. Training-mode
statistics are fp32 sums ``s1 = sum(x)`` and ``s2 = sum(x * x)`` over
every axis but the channel's; ``mean = s1 / count``, the biased ``var =
s2 / count - mean**2`` normalizes, and the running variance takes the
unbiased ``var * count / max(count - 1, 1)``, both running statistics
moving by ``momentum`` as written: ``(1 - momentum) * old + momentum *
new``. ``z`` (a residual) is added before the optional fused ReLU.
``apply_dtype`` below fp32 folds the normalization into a per-channel
``x * a + b`` computed in fp32 and applied at ``apply_dtype`` (ResNet-50's
bf16 path); otherwise the apply runs in fp32, ``keep_batchnorm_fp32``.

The statistics are one autograd function that saves only ``x``: its
backward is ``g1 + 2 * x * g2`` in fp32. Written as ``xf = x.float();
(xf * xf).sum()`` the autograd graph would keep an fp32 copy of every BN
input for the backward (2.7 GiB for each byte an element at ResNet-50's
batch 256).

Across ranks (``axis_name``, a mesh axis name or a ``ProcessGroup``;
``axis_index_groups`` for subgroups), the local ``(s1, s2, count)`` go
through one sum over the group, so the count-weighted statistics hold for
uneven batches a rank, as in the reference. That sum is differentiable:
its backward sums the grads of ``s1`` and ``s2`` over the group, the
transpose of ``psum`` that the reference's AD gives (and the
``allreduce(sum_dy, sum_dy_xmu)`` of apex's backward).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device

__all__ = ["BatchNormState", "SyncBatchNorm", "sync_batch_norm"]


class BatchNormState(NamedTuple):
    """Running statistics (fp32) and the count of training calls."""
    running_mean: torch.Tensor
    running_var: torch.Tensor
    num_batches_tracked: torch.Tensor


class _Sums(torch.autograd.Function):
    """``(sum(x), sum(x * x))`` over ``dims`` in fp32, saving only ``x``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dims: Tuple[int, ...]):
        ctx.save_for_backward(x)
        ctx.dims = dims
        xf = x.to(torch.float32)
        return xf.sum(dims), (xf * xf).sum(dims)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        shape = [1] * x.dim()
        c_ax = next(i for i in range(x.dim()) if i not in ctx.dims)
        shape[c_ax] = x.shape[c_ax]
        grad = torch.zeros((), dtype=torch.float32, device=x.device)
        if g2 is not None:
            grad = 2.0 * x.to(torch.float32) * g2.reshape(shape)
        if g1 is not None:
            grad = grad + g1.reshape(shape)
        return grad.expand(x.shape).to(x.dtype), None


def sync_batch_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    state: BatchNormState,
    *,
    training: bool = True,
    momentum: float = 0.1,
    eps: float = 1e-5,
    channel_axis: int = 1,
    axis_name: Optional[str] = None,
    axis_index_groups=None,
    z: Optional[torch.Tensor] = None,
    fuse_relu: bool = False,
    apply_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, BatchNormState]:
    """Returns ``(out, new_state)`` in ``x``'s dtype; ``new_state`` holds
    new tensors (the running statistics, detached) in training and is
    ``state`` in eval. ``channel_axis=1`` is NCHW, ``-1`` NHWC; an
    ``axis_name`` that is not bound raises ``ValueError``."""
    c_ax = channel_axis % x.dim()
    red = tuple(i for i in range(x.dim()) if i != c_ax)
    stat_shape = [1] * x.dim()
    stat_shape[c_ax] = x.shape[c_ax]

    if training:
        s1, s2 = _Sums.apply(x, red)
        count = s1.new_full((1,), float(math.prod(x.shape[i] for i in red)))
        if axis_name is not None:
            from apex_tpu_torch.parallel.distributed import grouped_psum
            c = s1.shape[0]
            summed = grouped_psum(torch.cat([s1, s2, count]), axis_name,
                                  axis_index_groups)
            s1, s2, count = summed[:c], summed[c:2 * c], summed[2 * c:]
        mean = s1 / count
        var = s2 / count - mean * mean  # biased, normalizes
        with torch.no_grad():
            unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
            new_state = BatchNormState(
                running_mean=(1 - momentum) * state.running_mean
                + momentum * mean,
                running_var=(1 - momentum) * state.running_var
                + momentum * unbiased,
                num_batches_tracked=state.num_batches_tracked + 1)
    else:
        mean, var = state.running_mean, state.running_var
        new_state = state

    inv = torch.rsqrt(var + eps)
    if apply_dtype is not None and apply_dtype != torch.float32:
        # the per-channel affine folded in fp32, applied at apply_dtype
        a = inv if weight is None else inv * weight.to(torch.float32)
        b = -mean * a
        if bias is not None:
            b = b + bias.to(torch.float32)
        a = a.to(apply_dtype).reshape(stat_shape)
        b = b.to(apply_dtype).reshape(stat_shape)
        out = x.to(apply_dtype) * a + b
        if z is not None:
            out = out + z.to(apply_dtype)
        if fuse_relu:
            out = torch.relu(out)
        return out.to(x.dtype), new_state
    xf = x.to(torch.float32)
    out = (xf - mean.reshape(stat_shape)) * inv.reshape(stat_shape)
    if weight is not None:
        out = out * weight.to(torch.float32).reshape(stat_shape)
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(stat_shape)
    if z is not None:
        out = out + z.to(torch.float32)
    if fuse_relu:
        out = torch.relu(out)
    return out.to(x.dtype), new_state


class SyncBatchNorm(nn.Module):
    """``apex.parallel.SyncBatchNorm`` at one device, as an ``nn.Module``:
    ``weight``/``bias`` parameters (``affine``) and ``running_mean``,
    ``running_var`` and ``num_batches_tracked`` buffers, updated in place
    by each training-mode call, as torch's BN updates them.
    ``track_running_stats=False`` always normalizes with the batch's
    statistics and leaves the buffers alone. ``apply_dtype`` and
    ``fuse_relu`` are :func:`sync_batch_norm`'s, and so are
    ``axis_name`` and ``axis_index_groups`` (resolved at each call);
    ``forward(x, z=None)``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = None, axis_index_groups=None,
                 channel_axis: int = 1, fuse_relu: bool = False,
                 param_dtype: torch.dtype = torch.float32,
                 apply_dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.num_features = num_features
        self.affine = affine
        self.axis_name = axis_name
        self.axis_index_groups = axis_index_groups
        self.param_dtype = param_dtype
        self.eps = eps
        self.momentum = momentum
        self.track_running_stats = track_running_stats
        self.channel_axis = channel_axis
        self.fuse_relu = fuse_relu
        self.apply_dtype = apply_dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(
                num_features, dtype=param_dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(
                num_features, dtype=param_dtype, device=dev))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("running_var", torch.ones(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("num_batches_tracked", torch.zeros(
            (), dtype=torch.long, device=dev))

    @property
    def state(self) -> BatchNormState:
        return BatchNormState(self.running_mean, self.running_var,
                              self.num_batches_tracked)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
        use_batch_stats = self.training or not self.track_running_stats
        out, new_state = sync_batch_norm(
            x, self.weight, self.bias, self.state, training=use_batch_stats,
            momentum=self.momentum, eps=self.eps,
            channel_axis=self.channel_axis, axis_name=self.axis_name,
            axis_index_groups=self.axis_index_groups, z=z,
            fuse_relu=self.fuse_relu, apply_dtype=self.apply_dtype)
        if use_batch_stats and self.track_running_stats:
            with torch.no_grad():
                for buf, new in zip(self.state, new_state):
                    buf.copy_(new)
        return out
