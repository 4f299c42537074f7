"""Data-parallel gradient synchronization over ``torch.distributed``.

Counterpart of ``apex_tpu/parallel/distributed.py``. The reference psums a
grad tree over a mesh axis inside ``shard_map``; the port all-reduces it
over the process group that the axis names for this rank
(:func:`~apex_tpu_torch.transformer.parallel_state.resolve_axis`: a mesh
axis name, or a ``ProcessGroup``), NCCL for tensors on the card and gloo
for tensors on the CPU. The numeric policy is the reference's:

- ``gradient_predivide_factor``: each grad divided by ``pre`` before the
  sum and multiplied by ``pre / world`` after it (``pre`` without
  averaging, when it is not 1);
- ``allreduce_always_fp32``: half grads widened to fp32 for the sum and
  cast back;
- ``gradient_average``: divide by the world size (by the size of this
  rank's group with ``axis_index_groups``, which may be uneven).

``axis_index_groups`` (lists of axis indices) become subgroups made with
``dist.new_group``: every rank makes every subgroup of every column of
the axis, in one order, as torch requires, once per set of groups.

**Bucketing** (``bucket_bytes``): the grad tree is cut into fixed-size
flat fp32 buckets on :func:`~apex_tpu_torch.optimizers._flatten.
bucket_bounds`' grid, each assembled from only the leaves of its span
(``ravel_span``) and all-reduced with ``async_op=True``; the buckets are
waited on together, scaled, and each leaf is rebuilt from only its own
buckets (``unravel_parts``). The bucketed path always sums in fp32. ZeRO
(:mod:`apex_tpu_torch.optimizers.distributed_fused`) reduce-scatters and
all-gathers over the same grid through :func:`reduce_scatter_grads`.
Overlap of the buckets with the backward (grad hooks) is not ported: the
buckets are issued after the backward.

The ``ddp/*`` metrics are recorded into an open in-step collector
(:mod:`apex_tpu_torch.observability.ingraph`) with the reference's
values. At health level ``"full"`` the synced grads go through the
replica-agreement watchdog (:func:`apex_tpu_torch.observability.health.
observe_replica_agreement`, ``health/ddp_grads/replica_divergence``):
they are the same on every replica by construction. Subgroup reduces are
exempt (their results differ between groups by design); below "full", or
with no collector open, it adds nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map

from apex_tpu_torch.observability import health as _health
from apex_tpu_torch.observability import ingraph as _metrics
from apex_tpu_torch.transformer.parallel_state import (axis_columns,
                                                       resolve_axis)

__all__ = ["allreduce_grads", "DistributedDataParallel", "Reducer",
           "grouped_psum", "reduce_scatter_grads", "all_reduce_sum",
           "DEFAULT_BUCKET_BYTES"]

# ~4 MiB a bucket, the reference's default (torch's DDP takes 25 MB)
DEFAULT_BUCKET_BYTES = 4 << 20


class _AllReduceSum(torch.autograd.Function):
    """A sum over a group whose backward sums the gradient over the same
    group: the transpose of ``psum``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group``; differentiable (the
    backward sums the gradient over the group) when ``x`` needs a
    gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


# (the axis's columns, groups) -> (this rank's subgroup, its size), for
# the default process group _SUBGROUPS_OF
_SUBGROUPS: Dict[Tuple, Tuple[Any, int]] = {}
_SUBGROUPS_OF: Any = None


def _subgroup(axis_name: Any, axis_index_groups) -> Tuple[Any, int]:
    """This rank's subgroup of ``axis_name`` and its size. Every rank
    makes every subgroup of every column, in one order; made once per
    set of columns and groups and default process group (a new
    ``init_process_group`` makes them anew)."""
    global _SUBGROUPS_OF
    if _SUBGROUPS_OF is not dist.group.WORLD:
        _SUBGROUPS.clear()
        _SUBGROUPS_OF = dist.group.WORLD
    groups = tuple(tuple(int(i) for i in g) for g in axis_index_groups)
    columns = axis_columns(axis_name)
    key = (tuple(map(tuple, columns)), groups)
    hit = _SUBGROUPS.get(key)
    if hit is not None:
        return hit
    me = dist.get_rank()
    mine = None
    for col in columns:
        members = sorted(i for g in groups for i in g)
        if members != list(range(len(col))):
            raise ValueError(
                f"axis_index_groups {[list(g) for g in groups]} must cover "
                f"the {len(col)} indices of axis {axis_name!r} once each")
        for g in groups:
            ranks = [col[i] for i in g]
            pg = dist.new_group(ranks)
            if me in ranks:
                mine = (pg, len(g))
    _SUBGROUPS[key] = mine
    return mine


def reduce_scatter_grads(flat: torch.Tensor, axis_name: Any,
                         async_op: bool = False):
    """The sum of a flat fp32 grad (bucket) over ``axis_name``, of which
    this rank receives its ``1 / world`` slice (the reference's tiled
    ``psum_scatter``). With ``async_op``, ``(out, work)``: ``out`` holds
    the slice once ``work.wait()`` returns."""
    group = resolve_axis(axis_name)
    world = dist.get_world_size(group)
    out = torch.empty(flat.numel() // world, dtype=flat.dtype,
                      device=flat.device)
    work = dist.reduce_scatter_tensor(out, flat.contiguous(), group=group,
                                      async_op=async_op)
    return (out, work) if async_op else out


def grouped_psum(x: torch.Tensor, axis_name: Any,
                 axis_index_groups: Optional[Sequence[Sequence[int]]] = None
                 ) -> torch.Tensor:
    """``x`` summed over ``axis_name``, or over this rank's group of
    ``axis_index_groups`` (the reference's subgroup ``psum``);
    differentiable."""
    if axis_index_groups is None:
        return all_reduce_sum(x, resolve_axis(axis_name))
    group, _ = _subgroup(axis_name, axis_index_groups)
    return all_reduce_sum(x, group)


def _check_exclusive(bucket_bytes, axis_index_groups) -> None:
    if bucket_bytes is not None and axis_index_groups is not None:
        raise ValueError(
            "bucket_bytes and axis_index_groups are mutually exclusive: "
            "the bucketed engine reduces over the full axis")


def _bucketed_allreduce(grads: Any, axis_name: Any,
                        gradient_predivide_factor: float,
                        gradient_average: bool, bucket_bytes: int) -> Any:
    """The bucketing engine: fp32 buckets on the shared grid, each built
    from its span's leaves and all-reduced asynchronously, waited on
    together, scaled, and unraveled leaf by leaf from its own buckets."""
    from apex_tpu_torch.optimizers._flatten import (bucket_bounds,
                                                    build_layout,
                                                    ravel_span,
                                                    unravel_parts)
    group = resolve_axis(axis_name)
    lay = build_layout(grads, chunks=1)
    bounds = bucket_bounds(lay, bucket_bytes)
    world = dist.get_world_size(group)
    pre = gradient_predivide_factor

    if _metrics.recording():
        _metrics.record("ddp/allreduce_bytes", float(4 * lay.total),
                        reduce="sum")
        _metrics.record("ddp/num_buckets", float(len(bounds)), reduce="mean")
        _metrics.record("ddp/bucket_bytes",
                        float(4 * max(n for _, n in bounds)), reduce="mean")

    if gradient_average:
        post = pre / world
    else:
        post = pre if pre != 1.0 else None

    pieces, works = [], []
    for off, n in bounds:
        b = ravel_span(grads, lay, off, n)
        if pre != 1.0:
            b = b / pre
        works.append(dist.all_reduce(b, group=group, async_op=True))
        pieces.append(b)
    for work in works:
        work.wait()
    if post is not None:
        pieces = [b * post for b in pieces]
    synced = unravel_parts(pieces, bounds, lay)
    _health.observe_replica_agreement(synced, axis_name, name="ddp_grads")
    return synced


def allreduce_grads(grads: Any, axis_name: Any = "data",
                    gradient_predivide_factor: float = 1.0,
                    allreduce_always_fp32: bool = False,
                    gradient_average: bool = True,
                    axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
                    bucket_bytes: Optional[int] = None) -> Any:
    """A new grad tree: ``grads`` summed over ``axis_name`` with apex
    DDP's numeric options (the module's docstring). One all-reduce a leaf
    (issued together, waited on together), or the bucketed engine with
    ``bucket_bytes``, which cannot be combined with
    ``axis_index_groups``."""
    _check_exclusive(bucket_bytes, axis_index_groups)
    if bucket_bytes is not None:
        return _bucketed_allreduce(grads, axis_name,
                                   gradient_predivide_factor,
                                   gradient_average, bucket_bytes)
    if axis_index_groups is not None:
        group, world = _subgroup(axis_name, axis_index_groups)
    else:
        group = resolve_axis(axis_name)
        world = dist.get_world_size(group)
    pre = gradient_predivide_factor
    leaves, spec = tree_flatten(grads)

    if _metrics.recording():
        # this rank's traffic a sync: one leaf is one "bucket"
        nbytes = sum(g.numel() * (4 if allreduce_always_fp32
                                  else g.element_size()) for g in leaves)
        _metrics.record("ddp/allreduce_bytes", float(nbytes), reduce="sum")
        _metrics.record("ddp/buckets", float(len(leaves)), reduce="mean")

    sums, works = [], []
    for g in leaves:
        x = g.to(torch.float32) if allreduce_always_fp32 else g
        x = x / pre if pre != 1.0 else x.clone()
        works.append(dist.all_reduce(x, group=group, async_op=True))
        sums.append(x)
    for work in works:
        work.wait()
    out = []
    for g, x in zip(leaves, sums):
        if gradient_average:
            x = x * (pre / world)
        elif pre != 1.0:
            x = x * pre
        out.append(x.to(g.dtype))
    synced = spec.unflatten(out)
    if axis_index_groups is None:
        _health.observe_replica_agreement(synced, axis_name,
                                          name="ddp_grads")
    return synced


class DistributedDataParallel:
    """Functional DDP: the sync policy, applied to grad trees.

    The constructor keeps the reference's argument names; the stream
    arguments are taken and ignored. ``bucket_bytes`` (the reference's
    ``message_size`` in bytes) routes :meth:`sync_gradients` through the
    bucketed engine. ``delay_allreduce=True`` makes :meth:`value_and_grad`
    return the unsynced grads of this rank (torch DDP's ``no_sync``), for
    a caller that sums a window of microbatches and syncs once
    (:func:`apex_tpu_torch.training.accumulate_gradients`).
    """

    def __init__(self, axis_name: Any = "data",
                 gradient_predivide_factor: float = 1.0,
                 allreduce_always_fp32: bool = False,
                 gradient_average: bool = True,
                 axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
                 delay_allreduce: bool = False,
                 bucket_bytes: Optional[int] = None,
                 **_ignored_stream_args):
        _check_exclusive(bucket_bytes, axis_index_groups)
        self.axis_name = axis_name
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_average = gradient_average
        self.axis_index_groups = axis_index_groups
        self.delay_allreduce = delay_allreduce
        self.bucket_bytes = bucket_bytes

    def sync_gradients(self, grads: Any) -> Any:
        return allreduce_grads(
            grads, self.axis_name, self.gradient_predivide_factor,
            self.allreduce_always_fp32, self.gradient_average,
            self.axis_index_groups, bucket_bytes=self.bucket_bytes)

    def value_and_grad(self, loss_fn, argnums: int = 0,
                       has_aux: bool = False, **vag_kwargs):
        """``fn(params, *args, **kwargs) -> (value, grads)`` (``((value,
        aux), grads)`` with ``has_aux``), the grads already synced (or
        not, with ``delay_allreduce``). ``params`` is a tree of leaf
        tensors that require grad; the grads are ``torch.autograd.grad``
        of the value, in the tree of ``params`` (zeros for a leaf the
        loss does not read), and nothing accumulates into ``.grad``.

        The reference passes any ``jax.value_and_grad`` keyword on. Of
        those, ``argnums=0`` (the params) and ``has_aux`` have a torch
        meaning; another ``argnums``, ``holomorphic``, ``allow_int`` or
        ``reduce_axes`` raises ``TypeError`` naming it."""
        if isinstance(argnums, bool) or argnums != 0:
            raise TypeError(
                f"DistributedDataParallel.value_and_grad: argnums="
                f"{argnums!r} has no torch meaning here; the grads are "
                "taken with respect to the first argument (argnums=0)")
        for key in vag_kwargs:
            raise TypeError(
                f"DistributedDataParallel.value_and_grad: the "
                f"jax.value_and_grad keyword {key!r} has no torch meaning "
                "(only argnums=0 and has_aux are taken)")

        def wrapped(params, *args, **kwargs):
            out = loss_fn(params, *args, **kwargs)
            value = out[0] if has_aux else out
            leaves, spec = tree_flatten(params)
            grads = spec.unflatten(list(torch.autograd.grad(
                value, leaves, allow_unused=True, materialize_grads=True)))
            if has_aux:
                out = (value.detach(), tree_map(
                    lambda x: x.detach() if isinstance(x, torch.Tensor)
                    else x, out[1]))
            else:
                out = value.detach()
            if self.delay_allreduce:
                return out, grads
            return out, self.sync_gradients(grads)

        return wrapped


class Reducer:
    """Explicit reduction of a tree (params or grads) to its mean over
    the axis, with no hooks (the reference's ``Reducer``):
    ``bucket_bytes`` takes the bucketed engine and cannot be combined
    with ``axis_index_groups``."""

    def __init__(self, axis_name: Any = "data",
                 axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
                 bucket_bytes: Optional[int] = None):
        _check_exclusive(bucket_bytes, axis_index_groups)
        self.axis_name = axis_name
        self.axis_index_groups = axis_index_groups
        self.bucket_bytes = bucket_bytes

    def reduce(self, tree: Any) -> Any:
        if self.axis_index_groups is not None:
            _, world = _subgroup(self.axis_name, self.axis_index_groups)
            return tree_map(
                lambda x: grouped_psum(x, self.axis_name,
                                       self.axis_index_groups) / world,
                tree)
        if self.bucket_bytes is not None:
            return _bucketed_allreduce(tree, self.axis_name, 1.0, True,
                                       self.bucket_bytes)
        group = resolve_axis(self.axis_name)
        world = dist.get_world_size(group)
        return tree_map(lambda x: all_reduce_sum(x, group) / world, tree)
