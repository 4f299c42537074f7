"""Spatial parallelism: the halo exchange and the height-sharded SAME
convolution.

Counterpart of ``apex_tpu/parallel/spatial.py`` (the reference's
``SpatialBottleneck`` in ``apex/contrib/bottleneck``). Each rank of the
process group of ``axis_name`` (a mesh axis name or a ``ProcessGroup``)
holds a slice of an NHWC image's height, in rank order. A halo is a hop
round the group's ring (:func:`apex_tpu_torch.parallel._p2p.rotate`,
whose backward is the reverse hop, so the halo's gradient goes back to
its owner); the first and last ranks put zeros in place of the rows that
wrapped round, the SAME padding of the dense conv, and ``torch.where``
passes no gradient to those rows' senders. The convolution is cuDNN's
``F.conv2d`` on the shard and its halos (HWIO weights, made OIHW).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch.parallel._p2p import rotate
from apex_tpu_torch.transformer.parallel_state import resolve_axis

__all__ = ["halo_exchange", "spatial_conv2d"]


def _halo(rows: torch.Tensor, group, step: int, zero: bool) -> torch.Tensor:
    (got,) = rotate((rows,), group, step)
    mask = torch.tensor(zero, device=got.device)
    return torch.where(mask, torch.zeros_like(got), got)


def halo_exchange(x: torch.Tensor, axis_name, halo: int = 1,
                  spatial_axis: int = 1,
                  halo_top: Optional[int] = None,
                  halo_bottom: Optional[int] = None) -> torch.Tensor:
    """This rank's shard with ``halo_top`` rows of the previous rank's
    above it and ``halo_bottom`` rows of the next rank's below it (both
    ``halo`` unless given) along ``spatial_axis``; the first rank's top
    and the last rank's bottom are zeros."""
    ht = halo if halo_top is None else halo_top
    hb = halo if halo_bottom is None else halo_bottom
    group = resolve_axis(axis_name)
    cp, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[spatial_axis]
    parts = []
    if ht:
        parts.append(_halo(x.narrow(spatial_axis, n - ht, ht), group, 1,
                           rank == 0))
    parts.append(x)
    if hb:
        parts.append(_halo(x.narrow(spatial_axis, 0, hb), group, -1,
                           rank == cp - 1))
    if len(parts) == 1:
        return x
    return torch.cat(parts, dim=spatial_axis)


def spatial_conv2d(x: torch.Tensor, w: torch.Tensor, axis_name,
                   stride: int = 1) -> torch.Tensor:
    """SAME 2D conv of an NHWC input whose height is sharded on
    ``axis_name``, with HWIO weights: each rank's output is the dense
    conv's slice of height for its shard. Odd kernel sizes, ``kh >
    stride``, and a ``stride`` that divides the local height, as the
    reference requires. Under stride SAME pads ``k - stride`` rows, low
    side first: the top halo is ``(k - stride) // 2`` rows, the bottom
    the rest; the width pads the same way, on this rank."""
    kh, kw = w.shape[0], w.shape[1]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("spatial_conv2d requires odd kernel sizes")
    if x.shape[1] % stride:
        raise ValueError("stride must divide the local shard height")
    if kh <= stride:
        raise ValueError("kernel height must exceed stride")
    pad_h = kh - stride
    x = halo_exchange(x, axis_name, spatial_axis=1, halo_top=pad_h // 2,
                      halo_bottom=pad_h - pad_h // 2)
    W = x.shape[2]
    out_w = -(-W // stride)
    pad_w = max((out_w - 1) * stride + kw - W, 0)
    xc = x.permute(0, 3, 1, 2)                       # NCHW, channels last
    xc = F.pad(xc, (pad_w // 2, pad_w - pad_w // 2, 0, 0))
    y = F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)
