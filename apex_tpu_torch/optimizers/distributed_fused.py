"""ZeRO-1: the optimizer state sharded over the data-parallel group.

Counterpart of ``apex_tpu/optimizers/distributed_fused.py``. A step is
three collectives over the process group of ``axis_name`` (a mesh axis
name or a ``ProcessGroup``):

1. the grad tree, raveled bucket by bucket into flat fp32
   (``_flatten.ravel_span``), is reduce-scattered: each rank receives the
   sum of its ``1 / dp`` slice of every bucket, multiplied by ``1 / dp``
   (DDP's average);
2. the optimizer's math runs on this rank's fp32 master shard and moments
   only, so a rank holds ``1 / dp`` of the dense optimizer state;
3. each bucket's updated master slice is all-gathered and the parameters
   are rebuilt leaf by leaf from their own buckets, in their own dtype
   (bf16 params keep an fp32 master).

The buckets lie on :func:`~apex_tpu_torch.optimizers._flatten.
bucket_bounds`' grid (``bucket_bytes``; ``None`` is one bucket), so a
rank's shard is bucket-major: its slice of bucket 0, then of bucket 1,
and so on. The state records the grid it was built with
(``bucket_stamp``, ``bucket_bytes`` or 0), and a step under another grid
raises instead of permuting every element. Every bucket's reduce-scatter
is issued at once (``async_op=True``); Adam's math then runs bucket by
bucket as each lands and issues that bucket's all-gather; everything is
waited on before the parameters are written. LAMB's math runs on the
whole shard (its global clip and per-tensor norms need every bucket):
the per-tensor norms are sums over this shard's segment ids
(``index_add_``) summed over the group.

The state lives on the parameters' device; ``step`` writes the new
parameters and state in place (the port's :class:`OptimizerBase`
protocol), and an overflow step (``grads_finite`` false) keeps both,
step count included. Call ``init`` and ``step`` on every rank of the
group. The ``ddp/*`` and ``zero/*`` metrics are recorded into an open
in-step collector with the reference's values.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.observability import ingraph as _metrics
from apex_tpu_torch.optimizers._base import (OptimizerBase, bias_correction,
                                             step_zero)
from apex_tpu_torch.optimizers._flatten import (FlatLayout, bucket_bounds,
                                                build_layout, ravel_span,
                                                span_segment_ids,
                                                unravel_parts)

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB",
           "ZeroAdamState", "ZeroLambState"]


class ZeroAdamState(NamedTuple):
    step: torch.Tensor        # int32 0-d
    master: torch.Tensor      # fp32, this rank's shard of the master params
    exp_avg: torch.Tensor     # fp32 shard
    exp_avg_sq: torch.Tensor  # fp32 shard
    # the bucket_bytes the shard layout was built with (0: one bucket), a
    # host int; the shards are bucket-major, so a step under another grid
    # would permute every element (check_state raises instead)
    bucket_stamp: Any = 0


# the same layout; one definition
ZeroLambState = ZeroAdamState


def _cat(parts: list) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class _DistributedFusedBase(OptimizerBase):
    """The flat-shard plumbing shared by the ZeRO optimizers, on the
    :mod:`~apex_tpu_torch.optimizers._flatten` layout with ``chunks`` the
    group's size."""

    def __init__(self, axis_name: Any = "data",
                 bucket_bytes: Optional[int] = None):
        self.axis_name = axis_name
        self.bucket_bytes = bucket_bytes
        self._layout: Optional[FlatLayout] = None
        self._seg_cache: dict = {}

    # -- the flat layout --------------------------------------------------
    def _group(self):
        from apex_tpu_torch.transformer.parallel_state import resolve_axis
        return resolve_axis(self.axis_name)

    def _dp(self, lay: FlatLayout) -> int:
        return lay.padded // lay.chunk

    def _layout_for(self, params: Any) -> FlatLayout:
        lay = build_layout(params,
                           chunks=dist.get_world_size(self._group()))
        if self._layout is not None and (
                self._layout.shapes != lay.shapes
                or self._layout.chunk != lay.chunk):
            raise ValueError("parameter structure changed between calls")
        self._layout = lay
        return lay

    def _bounds(self, lay: FlatLayout):
        """The buckets' ``(offset, size)`` spans of the flat vector."""
        return bucket_bounds(lay, self.bucket_bytes)

    def _stamp(self) -> int:
        return int(self.bucket_bytes or 0)

    def check_state(self, state: Any) -> None:
        """``ValueError`` when ``state`` was built under another
        ``bucket_bytes`` than this optimizer's: its shards are
        bucket-major, and stepping them would permute master params and
        moments."""
        stamp = getattr(state, "bucket_stamp", None)
        if stamp is None:
            return
        got = int(stamp)
        if got != self._stamp():
            raise ValueError(
                f"ZeRO state was built with bucket_bytes={got or None} but "
                f"this optimizer is configured with bucket_bytes="
                f"{self.bucket_bytes}; the flat shard layout is "
                f"bucket-major, so stepping it would silently permute "
                f"master params and moments. Rebuild the state (init) or "
                f"restore with the matching ddp_bucket_bytes.")

    def _shard_bounds(self, lay: FlatLayout):
        """Each bucket's ``(offset, size)`` within this rank's shard."""
        dp = self._dp(lay)
        out, off = [], 0
        for _goff, n in self._bounds(lay):
            out.append((off, n // dp))
            off += n // dp
        return tuple(out)

    def _my_spans(self, lay: FlatLayout):
        """This rank's slice of each bucket, as flat-vector spans."""
        rank = dist.get_rank(self._group())
        dp = self._dp(lay)
        return [(off + rank * (n // dp), n // dp)
                for off, n in self._bounds(lay)]

    def _my_segments(self, lay: FlatLayout, device) -> torch.Tensor:
        """The leaf index of every element of this rank's shard."""
        key = (lay, dist.get_rank(self._group()), self.bucket_bytes, device)
        seg = self._seg_cache.get(key)
        if seg is None:
            seg = _cat([span_segment_ids(lay, off, n, device=device)
                        for off, n in self._my_spans(lay)])
            self._seg_cache = {key: seg}
        return seg

    def _init_shard(self, params: Any) -> Tuple[torch.Tensor, FlatLayout]:
        lay = self._layout_for(params)
        master = _cat([ravel_span(params, lay, off, n)
                       for off, n in self._my_spans(lay)])
        return master, lay

    def _shard_grad_parts(self, grads: Any, lay: FlatLayout) -> list:
        """Every bucket's reduce-scatter issued at once: ``[(slice,
        work)]``; wait on ``work``, then multiply the slice by
        ``1 / dp``."""
        from apex_tpu_torch.parallel.distributed import reduce_scatter_grads
        bounds = self._bounds(lay)
        if _metrics.recording():
            _metrics.record("ddp/reduce_scatter_bytes",
                            float(4 * lay.padded), reduce="sum")
            _metrics.record("zero/shard_bytes", float(4 * lay.chunk),
                            reduce="mean")
            if self.bucket_bytes is not None:
                # the bucket grid's metrics belong to the bucketed path
                _metrics.record("ddp/num_buckets", float(len(bounds)),
                                reduce="mean")
                _metrics.record("ddp/bucket_bytes",
                                float(4 * max(n for _, n in bounds)),
                                reduce="mean")
        return [reduce_scatter_grads(ravel_span(grads, lay, off, n),
                                     self.axis_name, async_op=True)
                for off, n in bounds]

    def _all_gather(self, part: torch.Tensor):
        """A bucket's updated master slice gathered from every rank:
        ``(full bucket, work)``."""
        group = self._group()
        full = torch.empty(part.numel() * dist.get_world_size(group),
                           dtype=part.dtype, device=part.device)
        work = dist.all_gather_into_tensor(full, part.contiguous(),
                                           group=group, async_op=True)
        return full, work

    def _unravel(self, gathered: list, lay: FlatLayout) -> Any:
        """Wait on the gathers, then rebuild the parameter tree."""
        parts = []
        for full, work in gathered:
            work.wait()
            parts.append(full)
        return unravel_parts(parts, self._bounds(lay), lay)

    def _scalars(self, state, lr, weight_decay):
        dev = state.master.device
        lr = torch.as_tensor(self.lr if lr is None else lr,
                             dtype=torch.float32, device=dev)
        wd = torch.as_tensor(
            self.weight_decay if weight_decay is None else weight_decay,
            dtype=torch.float32, device=dev)
        t = state.step + 1
        if self.use_bias_correction:
            bc1 = bias_correction(self.beta1, t)
            bc2 = bias_correction(self.beta2, t)
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32, device=dev)
        return lr, wd, t, bc1, bc2

    def _zero_state(self, params: Any) -> ZeroAdamState:
        master, lay = self._init_shard(params)
        return ZeroAdamState(step=step_zero(params), master=master,
                             exp_avg=torch.zeros_like(master),
                             exp_avg_sq=torch.zeros_like(master),
                             bucket_stamp=self._stamp())

    @torch.no_grad()
    def step(self, grads: Any, state: Any, params: Any,
             grads_finite: Optional[torch.Tensor] = None,
             **kw) -> Tuple[Any, Any]:
        self.check_state(state)
        return super().step(grads, state, params,
                            grads_finite=grads_finite, **kw)


class DistributedFusedAdam(_DistributedFusedBase):
    """ZeRO-sharded Adam/AdamW: :class:`~apex_tpu_torch.optimizers.
    FusedAdam`'s arithmetic on DDP-averaged grads, with fp32 master,
    ``exp_avg`` and ``exp_avg_sq`` each ``1 / dp`` of the dense state."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 axis_name: Any = "data",
                 bucket_bytes: Optional[int] = None):
        super().__init__(axis_name, bucket_bytes=bucket_bytes)
        self.lr = lr
        self.use_bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay

    def init(self, params: Any) -> ZeroAdamState:
        return self._zero_state(params)

    def _step(self, grads: Any, state: ZeroAdamState, params: Any,
              lr: Optional[Any] = None,
              weight_decay: Optional[Any] = None
              ) -> Tuple[Any, ZeroAdamState]:
        lay = self._layout_for(params)
        lr, wd, t, bc1, bc2 = self._scalars(state, lr, weight_decay)
        b1, b2 = self.beta1, self.beta2
        inv_dp = 1.0 / self._dp(lay)
        scattered = self._shard_grad_parts(grads, lay)
        ms, vs, masters, gathered = [], [], [], []
        for (g, work), (o, n) in zip(scattered, self._shard_bounds(lay)):
            work.wait()
            g = g * inv_dp
            p32 = state.master[o:o + n]
            if not self.adam_w_mode:
                g = g + wd * p32
            m = b1 * state.exp_avg[o:o + n] + (1.0 - b1) * g
            v = b2 * state.exp_avg_sq[o:o + n] + (1.0 - b2) * g * g
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.adam_w_mode:
                update = update + wd * p32
            new_master = p32 - lr * update
            ms.append(m)
            vs.append(v)
            masters.append(new_master)
            gathered.append(self._all_gather(new_master))
        new_params = self._unravel(gathered, lay)
        return new_params, ZeroAdamState(
            step=t, master=_cat(masters), exp_avg=_cat(ms),
            exp_avg_sq=_cat(vs), bucket_stamp=state.bucket_stamp)


class DistributedFusedLAMB(_DistributedFusedBase):
    """ZeRO-sharded LAMB: the global grad-norm clip, then per-tensor trust
    ratios from norms summed over the group (exact, by segment ids)."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, axis_name: Any = "data",
                 bucket_bytes: Optional[int] = None):
        super().__init__(axis_name, bucket_bytes=bucket_bytes)
        self.lr = lr
        self.use_bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb

    def init(self, params: Any) -> ZeroLambState:
        return self._zero_state(params)

    def _step(self, grads: Any, state: ZeroLambState, params: Any,
              lr: Optional[Any] = None,
              weight_decay: Optional[Any] = None
              ) -> Tuple[Any, ZeroLambState]:
        from apex_tpu_torch.parallel.distributed import all_reduce_sum
        group = self._group()
        lay = self._layout_for(params)
        lr, wd, t, bc1, bc2 = self._scalars(state, lr, weight_decay)
        b1, b2 = self.beta1, self.beta2
        inv_dp = 1.0 / self._dp(lay)
        seg = self._my_segments(lay, state.master.device)
        parts = []
        for g, work in self._shard_grad_parts(grads, lay):
            work.wait()
            parts.append(g * inv_dp)
        g = _cat(parts)
        # the global grad-norm clip
        gnorm = torch.sqrt(all_reduce_sum(torch.sum(g * g), group))
        if self.max_grad_norm > 0:
            clip = torch.where(gnorm > self.max_grad_norm,
                               gnorm / self.max_grad_norm,
                               torch.ones_like(gnorm))
            g = g / clip

        p32 = state.master
        m = b1 * state.exp_avg + (1.0 - b1) * g
        v = b2 * state.exp_avg_sq + (1.0 - b2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + wd * p32

        # per-tensor trust ratios; the last slot is the padding's
        n_seg = len(lay.sizes) + 1
        sums = torch.zeros(2, n_seg, dtype=torch.float32, device=p32.device)
        sums[0].index_add_(0, seg, p32 * p32)
        sums[1].index_add_(0, seg, update * update)
        p_norm, u_norm = torch.sqrt(all_reduce_sum(sums, group)).unbind()
        ones = torch.ones_like(p_norm)
        if self.use_nvlamb:
            ratio = torch.where(u_norm > 0, p_norm / u_norm, ones)
        else:
            ratio = torch.where((p_norm > 0) & (u_norm > 0),
                                p_norm / u_norm, ones)
        new_master = p32 - lr * ratio[seg] * update
        gathered = [self._all_gather(new_master[o:o + n])
                    for o, n in self._shard_bounds(lay)]
        new_params = self._unravel(gathered, lay)
        return new_params, ZeroLambState(
            step=t, master=new_master, exp_avg=m, exp_avg_sq=v,
            bucket_stamp=state.bucket_stamp)
