"""Flat-buffer parameter layout, the ``multi_tensor_apply`` memory tier.

Counterpart of ``apex_tpu/optimizers/_flatten.py``: the
static layout of a tree (spec, shapes, dtypes, offsets, the length padded
to a multiple of ``chunks``) that :class:`~apex_tpu_torch.optimizers.
FlatOptimizer` runs its elementwise update over, as one fp32 vector.
:func:`build_layout` memoizes the layout on the tree's static identity, so
a loop that rebuilds it every step gets the same object back.

The span helpers serve the bucketed DDP allreduce and ZeRO
(:mod:`apex_tpu_torch.parallel.distributed`,
:mod:`apex_tpu_torch.optimizers.distributed_fused`):
:func:`bucket_bounds` carves the padded vector into fixed-size buckets,
:func:`ravel_span` builds one bucket's slice from only the leaves that
overlap it (no leaf outside the span is read, and the full flat vector is
never built), :func:`unravel_parts` rebuilds each leaf from only the
pieces that cover it, and :func:`segment_ids` maps a flat index to its
leaf (LAMB's per-tensor norms over a shard). Values are element for
element those of :func:`ravel`/:func:`unravel`.
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import TreeSpec, tree_flatten, tree_unflatten

__all__ = ["FlatLayout", "build_layout", "ravel", "unravel", "segment_ids",
           "bucket_bounds", "ravel_span", "unravel_parts", "span_segment_ids",
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
# layout -> its full segment-id map (int32, on the CPU): O(padded) bytes,
# so the cache is bounded by bytes, not entries
_SEGMENT_CACHE: dict = {}
_SEGMENT_CACHE_MAX_BYTES = 256 << 20


def layout_cache_stats() -> dict:
    """``{"hits": n, "misses": n}`` of the :func:`build_layout` memo."""
    return dict(_LAYOUT_STATS)


def clear_layout_cache() -> None:
    _LAYOUT_CACHE.clear()
    _SEGMENT_CACHE.clear()
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


def _leaves_of(tree: Any, lay: FlatLayout) -> list:
    leaves, treedef = tree_flatten(tree)
    if treedef != lay.treedef:
        raise ValueError(f"tree structure {treedef} is not the layout's "
                         f"{lay.treedef}")
    return leaves


def ravel_span(tree: Any, lay: FlatLayout, off: int, size: int
               ) -> torch.Tensor:
    """``ravel(tree, lay)[off:off + size]`` built from only the leaves
    that overlap ``[off, off + size)``: no other leaf is read, and the
    full flat vector is never built. Always a new fp32 tensor (never a
    view of a leaf), so a collective may reduce it in place."""
    end = off + size
    if off < 0 or size <= 0 or end > lay.padded:
        raise ValueError(f"span [{off}, {end}) outside padded length "
                         f"{lay.padded} (or empty)")
    parts: List[torch.Tensor] = []
    device = None
    for leaf, loff, lsize in zip(_leaves_of(tree, lay), lay.offsets,
                                 lay.sizes):
        lo, hi = max(off, loff), min(end, loff + lsize)
        if lo >= hi:
            continue
        piece = leaf.reshape(-1)[lo - loff:hi - loff]
        device = piece.device
        parts.append(piece.to(torch.float32))
    covered = max(0, min(end, lay.total) - min(off, lay.total))
    if covered < size:           # the padding tail past lay.total
        parts.append(torch.zeros(size - covered, dtype=torch.float32,
                                 device=device))
    return torch.cat(parts)


def unravel_parts(parts: Sequence[torch.Tensor],
                  bounds: Sequence[Tuple[int, int]],
                  lay: FlatLayout) -> Any:
    """The tree rebuilt from per-span flat pieces (``parts[i]`` covers
    ``bounds[i]``; the bounds tile the padded vector in order), each leaf
    from only the pieces that cover it, in its own dtype: element for
    element ``unravel(cat(parts), lay)``."""
    if len(parts) != len(bounds):
        raise ValueError(f"{len(parts)} parts vs {len(bounds)} bounds")
    off = 0
    for boff, bsize in bounds:
        if boff != off or bsize <= 0:
            raise ValueError(
                f"bounds {tuple(bounds)} do not tile the flat vector "
                f"(expected contiguous spans from 0 to {lay.padded})")
        off += bsize
    if off != lay.padded:
        raise ValueError(
            f"bounds cover [0, {off}) but the layout is padded to "
            f"{lay.padded} — every leaf must be covered")
    device = parts[0].device if parts else None
    leaves = []
    for shape, dtype, lsize, loff in zip(lay.shapes, lay.dtypes,
                                         lay.sizes, lay.offsets):
        lend = loff + lsize
        if lsize == 0:      # a zero-size leaf occupies no span
            leaves.append(torch.zeros(shape, dtype=dtype, device=device))
            continue
        pieces = [part[max(loff, boff) - boff:min(lend, boff + bsize) - boff]
                  for (boff, bsize), part in zip(bounds, parts)
                  if max(loff, boff) < min(lend, boff + bsize)]
        flat_leaf = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        leaves.append(flat_leaf.reshape(shape).to(dtype))
    return tree_unflatten(leaves, lay.treedef)


def bucket_bounds(lay: FlatLayout,
                  bucket_bytes: Optional[int]) -> Tuple[Tuple[int, int], ...]:
    """``(offset, size)`` spans carving the padded vector into buckets of
    ``bucket_bytes`` fp32 bytes, each size a multiple of the shard count
    the layout was built for (``lay.padded // lay.chunk``), so each
    bucket reduce-scatters evenly. ``None``: one span, the whole
    vector."""
    if bucket_bytes is None:
        return ((0, lay.padded),)
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    chunks = lay.padded // lay.chunk if lay.chunk else 1
    per = max(1, int(bucket_bytes) // 4)          # fp32 elements a bucket
    per = ((per + chunks - 1) // chunks) * chunks  # divisible by the shards
    bounds = []
    off = 0
    while off < lay.padded:
        n = min(per, lay.padded - off)  # the tail divides too: padded % chunks == 0
        bounds.append((off, n))
        off += n
    return tuple(bounds) or ((0, 0),)


def span_segment_ids(lay: FlatLayout, off: int, size: int,
                     device=None) -> torch.Tensor:
    """The leaf index of each flat index in ``[off, off + size)`` (int64;
    the padding gets ``len(lay.sizes)``), built for that span alone."""
    ends = torch.tensor([o + n for o, n in zip(lay.offsets, lay.sizes)],
                        dtype=torch.int64, device=device)
    idx = torch.arange(off, off + size, dtype=torch.int64, device=device)
    return torch.searchsorted(ends, idx, right=True)


def segment_ids(lay: FlatLayout) -> torch.Tensor:
    """The flat index -> leaf index map over the padded vector (int32,
    on the CPU; the padding gets the extra id ``len(lay.sizes)``, so it
    never joins a real leaf's norm). Memoized per layout; a fresh copy
    each call."""
    try:
        ids, key = _SEGMENT_CACHE.get(lay), lay
    except TypeError:       # a spec whose context does not hash
        ids, key = None, None
    if ids is None:
        ids = span_segment_ids(lay, 0, lay.padded).to(torch.int32)
        if key is not None and ids.numel() * 4 <= _SEGMENT_CACHE_MAX_BYTES:
            total = sum(v.numel() * 4 for v in _SEGMENT_CACHE.values())
            while _SEGMENT_CACHE and \
                    total + ids.numel() * 4 > _SEGMENT_CACHE_MAX_BYTES:
                total -= _SEGMENT_CACHE.pop(
                    next(iter(_SEGMENT_CACHE))).numel() * 4
            _SEGMENT_CACHE[key] = ids
    return ids.clone()
