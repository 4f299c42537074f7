"""Cross-world-size resharding of bucket-major ZeRO flat shards.

Counterpart of ``apex_tpu/elastic/reshard.py``. A ZeRO rank's shard of
the fp32 master params and moments is a function of the dp grid twice
over: the flat vector is padded to ``ceil(total / dp) * dp`` elements,
and the shard is bucket-major, rank ``r``'s shard being the concatenation
over buckets of bucket ``b``'s ``r``-th ``1/dp`` slice, with the buckets
rounded to multiples of dp (:func:`apex_tpu_torch.optimizers._flatten.
bucket_bounds`). A dp 4 checkpoint read verbatim into a dp 2 world would
permute every element. These functions recover the natural (leaf-order)
vector from the old grid's global array and lay it out on the new grid:
an index permutation, no arithmetic, so element-identical.

The global array is the concatenation of every rank's shard in (pipe,
data, tensor) order, as :func:`apex_tpu_torch.checkpoint.
restore_checkpoint` returns it for a ZeRO leaf whose target is the whole;
each of its ``pp * tp`` (pipe, tensor) columns reshards on its own. The
functions take numpy arrays or tensors and give back the same kind
(a tensor on its device).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from apex_tpu_torch.optimizers._flatten import FlatLayout, bucket_bounds

__all__ = ["flat_grid", "shard_permutation", "to_natural", "from_natural",
           "reshard_flat", "reshard_zero_state"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(arr: np.ndarray, x):
    """``arr`` as the kind of ``x``: a tensor on ``x``'s device, or numpy."""
    if isinstance(x, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(x.device)
    return arr


def flat_grid(total: int, dp: int, bucket_bytes):
    """``(padded, bounds)`` of a ``total``-element flat vector sharded
    ``dp`` ways under ``bucket_bytes`` (0 or None: one bucket): the grid
    :func:`~apex_tpu_torch.optimizers._flatten.bucket_bounds` gives the
    optimizers, from two integers instead of a parameter tree."""
    if total < 1 or dp < 1:
        raise ValueError(f"need total >= 1 and dp >= 1, got {total}/{dp}")
    bucket_bytes = bucket_bytes or None  # sidecars spell monolithic as 0
    padded = -(-total // dp) * dp
    lay = FlatLayout(treedef=None, shapes=(), dtypes=(), sizes=(),
                     offsets=(), total=total, padded=padded,
                     chunk=padded // dp)
    return padded, bucket_bounds(lay, bucket_bytes)


def shard_permutation(total: int, dp: int, bucket_bytes) -> np.ndarray:
    """Index map ``idx`` (length ``padded``) with
    ``data_axis_global = natural_padded[idx]``: position ``p`` of the
    dp-concatenated bucket-major global vector holds natural element
    ``idx[p]``. Rank-major outer order (the data-axis concatenation),
    bucket-major inner (a rank's ``_my_spans``)."""
    padded, bounds = flat_grid(total, dp, bucket_bytes)
    idx = np.empty(padded, np.int64)
    pos = 0
    for r in range(dp):
        for goff, n in bounds:
            nb = n // dp
            idx[pos:pos + nb] = np.arange(goff + r * nb,
                                          goff + (r + 1) * nb)
            pos += nb
    return idx


def to_natural(col, total: int, dp: int, bucket_bytes):
    """One (pipe, tensor) column of the dp-sharded global vector back to
    natural leaf order, padding dropped: the inverse permutation."""
    arr = _host(col)
    padded, _ = flat_grid(total, dp, bucket_bytes)
    if arr.shape != (padded,):
        raise ValueError(
            f"column has shape {arr.shape}, expected ({padded},) for "
            f"total={total} sharded dp={dp}")
    nat = np.empty_like(arr)
    nat[shard_permutation(total, dp, bucket_bytes)] = arr
    return _like(nat[:total], col)


def from_natural(nat, dp: int, bucket_bytes):
    """Natural leaf-order vector (length ``total``) to the dp-sharded
    bucket-major global order, zero-padded to the new grid."""
    arr = _host(nat)
    total = arr.shape[0]
    padded, _ = flat_grid(total, dp, bucket_bytes)
    if padded != total:
        arr = np.concatenate([arr, np.zeros(padded - total, arr.dtype)])
    return _like(arr[shard_permutation(total, dp, bucket_bytes)], nat)


_SAME = object()  # "same grid on both sides" default sentinel


def reshard_flat(arr, *, total: int, dp_old: int, dp_new: int,
                 bucket_bytes, bucket_bytes_new=_SAME, pp: int = 1,
                 tp: int = 1):
    """Re-partition a (pipe, data, tensor)-order global flat vector from
    a ``dp_old`` grid to a ``dp_new`` grid (shrink or grow;
    ``bucket_bytes_new`` also re-buckets, free here through the natural
    order). Element-identical on the natural content:
    ``to_natural(reshard_flat(x)) == to_natural(x)`` for every column,
    exactly; only the padding tail is rebuilt (zeros)."""
    if bucket_bytes_new is _SAME:
        bucket_bytes_new = bucket_bytes
    src = _host(arr)
    padded_old, _ = flat_grid(total, dp_old, bucket_bytes)
    padded_new, _ = flat_grid(total, dp_new, bucket_bytes_new)
    if src.shape != (pp * dp_old * tp * (padded_old // dp_old),):
        raise ValueError(
            f"flat array has shape {src.shape}, expected "
            f"({pp * tp * padded_old},) for total={total} over "
            f"pp={pp} x dp={dp_old} x tp={tp}")
    # (pp, dp, tp, chunk) mesh order -> (pp, tp) columns of (padded,)
    cols = src.reshape(pp, dp_old, tp, padded_old // dp_old) \
              .transpose(0, 2, 1, 3).reshape(pp * tp, padded_old)
    # each permutation depends only on (total, dp, bucket_bytes): built
    # once, not once a column
    idx_old = shard_permutation(total, dp_old, bucket_bytes)
    idx_new = shard_permutation(total, dp_new, bucket_bytes_new)

    def recolumn(col):
        nat = np.empty_like(col)
        nat[idx_old] = col                      # inverse of the old grid
        if padded_new > total:
            nat = np.concatenate(
                [nat[:total], np.zeros(padded_new - total, nat.dtype)])
        else:
            nat = nat[:padded_new]
        return nat[idx_new]                     # forward onto the new

    new_cols = np.stack([recolumn(c) for c in cols])
    out = new_cols.reshape(pp, tp, dp_new, padded_new // dp_new) \
                  .transpose(0, 2, 1, 3).reshape(-1)
    return _like(out, arr)


def reshard_zero_state(opt_state: Any, *, total: int, dp_old: int,
                       dp_new: int, bucket_bytes,
                       bucket_bytes_new=_SAME, pp: int = 1,
                       tp: int = 1) -> Any:
    """Every flat-shard leaf (``master``, ``exp_avg``, ``exp_avg_sq``) of
    a global :class:`~apex_tpu_torch.optimizers.ZeroAdamState` or
    ``ZeroLambState`` (the concatenation of the ranks' shards) resharded
    from ``dp_old`` to ``dp_new``; ``step`` and ``bucket_stamp`` pass
    through, and the optimizer's ``check_state`` validates the stamp on
    the new world. Rank ``r`` of the new data group takes the ``r``-th
    ``1/dp_new`` of each result (per (pipe, tensor) column)."""
    kw = dict(total=total, dp_old=dp_old, dp_new=dp_new,
              bucket_bytes=bucket_bytes, bucket_bytes_new=bucket_bytes_new,
              pp=pp, tp=tp)
    return opt_state._replace(
        master=reshard_flat(opt_state.master, **kw),
        exp_avg=reshard_flat(opt_state.exp_avg, **kw),
        exp_avg_sq=reshard_flat(opt_state.exp_avg_sq, **kw))
