"""Flat-buffer parameter layout, the ``multi_tensor_apply`` memory tier.

Counterpart of ``apex_tpu/optimizers/_flatten.py`` at one device: the
static layout of a tree (spec, shapes, dtypes, offsets, the length padded
to a multiple of ``chunks``) that :class:`~apex_tpu_torch.optimizers.
FlatOptimizer` runs its elementwise update over, as one fp32 vector.
:func:`build_layout` memoizes the layout on the tree's static identity, so
a loop that rebuilds it every step gets the same object back. The span
and segment helpers of the reference (``ravel_span``, ``unravel_parts``,
``bucket_bounds``, ``segment_ids``) serve its ZeRO and bucketed DDP tiers,
which come with multi-GPU (queue item A5).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch
from torch.utils._pytree import TreeSpec, tree_flatten, tree_unflatten

__all__ = ["FlatLayout", "build_layout", "ravel", "unravel",
           "layout_cache_stats", "clear_layout_cache"]


class FlatLayout(NamedTuple):
    treedef: TreeSpec
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int
    padded: int
    chunk: int            # padded // chunks


# (treedef, shapes, dtypes, chunks) -> FlatLayout: a hit returns the very
# object the first build made. A bounded FIFO, so a process cycling
# through many models does not keep their layouts.
_LAYOUT_CACHE: dict = {}
_LAYOUT_CACHE_MAX = 64
_LAYOUT_STATS = {"hits": 0, "misses": 0}


def layout_cache_stats() -> dict:
    """``{"hits": n, "misses": n}`` of the :func:`build_layout` memo."""
    return dict(_LAYOUT_STATS)


def clear_layout_cache() -> None:
    _LAYOUT_CACHE.clear()
    _LAYOUT_STATS["hits"] = _LAYOUT_STATS["misses"] = 0


def build_layout(params: Any, chunks: int = 1) -> FlatLayout:
    """The layout of ``params``; the padded length divides into
    ``chunks``. Memoized on the tree's spec, shapes, dtypes and
    ``chunks``."""
    leaves, treedef = tree_flatten(params)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    dtypes = tuple(leaf.dtype for leaf in leaves)
    key = (treedef, shapes, dtypes, int(chunks))
    try:
        cached = _LAYOUT_CACHE.get(key)
    except TypeError:       # a spec whose context does not hash
        cached, key = None, None
    if cached is not None:
        _LAYOUT_STATS["hits"] += 1
        return cached
    _LAYOUT_STATS["misses"] += 1
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, off = [], 0
    for size in sizes:
        offsets.append(off)
        off += size
    total = off
    padded = ((total + chunks - 1) // chunks) * chunks
    lay = FlatLayout(treedef, shapes, dtypes, sizes, tuple(offsets), total,
                     padded, padded // chunks)
    if key is not None:
        if len(_LAYOUT_CACHE) >= _LAYOUT_CACHE_MAX:
            _LAYOUT_CACHE.pop(next(iter(_LAYOUT_CACHE)))
        _LAYOUT_CACHE[key] = lay
    return lay


def ravel(tree: Any, lay: FlatLayout) -> torch.Tensor:
    """The leaves concatenated into one flat fp32 vector, zero-padded to
    ``lay.padded``."""
    leaves, treedef = tree_flatten(tree)
    if treedef != lay.treedef:
        raise ValueError(f"tree structure {treedef} is not the layout's "
                         f"{lay.treedef}")
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    if lay.padded != lay.total:
        flat = torch.nn.functional.pad(flat, (0, lay.padded - lay.total))
    return flat


def unravel(flat: torch.Tensor, lay: FlatLayout) -> Any:
    """The flat vector sliced back into the tree, each leaf in its dtype:
    fp32 leaves are views of ``flat``, others are cast copies."""
    leaves = [flat[off:off + size].view(shape).to(dtype)
              for shape, dtype, size, off in zip(lay.shapes, lay.dtypes,
                                                 lay.sizes, lay.offsets)]
    return tree_unflatten(leaves, lay.treedef)
