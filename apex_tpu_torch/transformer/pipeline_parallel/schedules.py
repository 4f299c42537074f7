"""Pipeline-parallel forward and backward schedules.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/schedules.py``
(upstream ``apex/transformer/pipeline_parallel/schedules/``): the
dispatcher :func:`get_forward_backward_func`, no pipelining, 1F1B without
interleaving, the interleaved virtual pipeline, and the forward-only
:func:`pipelined_apply`. The reference traces a schedule as one scan of
ticks inside ``shard_map``; here every rank of the pipeline group is a
process that runs its own stages eagerly, microbatch by microbatch, and
passes activations and their grads to its neighbours through the stage
hops (:mod:`~apex_tpu_torch.transformer.pipeline_parallel.
p2p_communication`). Bubbles are idle time, not work on zeros.

How a pipelined schedule runs:

- **1F1B without interleaving** (``memory_efficient=True``, one chunk a
  rank): upstream Megatron's warmup, steady state and cooldown. Pipeline
  rank ``r`` of ``S`` runs ``min(S - r - 1, M)`` forwards, then
  alternates one forward and one backward, then drains, so at most
  ``S - r`` microbatches are in flight on it. A hop pairs a send with a
  receive where the schedule does (``send_forward_recv_backward``,
  ``send_backward_recv_forward``).
- **1F1B, interleaved** (``memory_efficient=True``, ``V`` chunks a
  rank): the reference's tick layout. Chunk ``c`` on pipeline rank ``d``
  is global stage ``g = c * S + d`` of ``L = S * V``; microbatch ``m``
  runs forward on global stage ``g`` at tick ``m + g`` and backward at
  tick ``m + 2L - 1 - g``; each tick runs its backwards, then its
  forwards, each followed by one hop. At most ``2(L - g) - 1``
  microbatches are in flight on global stage ``g``, so ``2(L - c * S) -
  1`` on chunk ``c``.
- **All forwards, then all backwards** (``memory_efficient=False``, any
  number of chunks): the output equivalent of the reference's AD pass through its ticks;
  every microbatch's graph stays alive until its backward, so the
  activations grow with ``M``.

Each stage keeps its graph (the saved activations) from its forward to
its backward and lets it go when that backward has run: upstream's
``free_output_tensor``. Nothing is recomputed unless the ``remat``
policy asks for it (the reference's 1F1B recomputes each stage forward
inside its backward, because a scan carry is its only memory).

The contract whatever the order: ``stage_fn(params, x, global_stage)``
is a stage's body; ``loss_fn(y, m)`` (or ``loss_fn(shared, y, m)``) the
per-microbatch loss on the last global stage. The loss returned is the
mean over the ``M`` microbatches, computed on the last stage and the
same on every rank; the grads are the fp32 grads of ``loss *
grad_scale`` divided by ``grad_scale``, accumulated microbatch by
microbatch in order. ``shared_params`` (the pipelined embedding on
global stage 0 through ``embed_fn(shared, microbatch)``, the tied head on
the last) stay replicated over the pipeline group: each rank's shared
grads are summed over the group, the middle stages adding zeros, so
every stage holds the same shared grads (the reference's ``psum`` over
``pipe``; without it the replicas would step the shared params with
different grads and drift apart).

A parameter tree is a tree of tensors and modules
(:func:`~apex_tpu_torch.transformer.pipeline_parallel.utils.param_tree`),
and its grads come back as the matching tree of tensors; chunked
parameters (the interleaved schedule, :func:`pipelined_apply`) are a
sequence of one tree a chunk, where the reference stacks a leading chunk
axis.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from apex_tpu_torch.observability import ingraph as _metrics
from apex_tpu_torch.remat import RematPolicy
from apex_tpu_torch.transformer.pipeline_parallel.p2p_communication import (
    _Pipe, exchange_stages)
from apex_tpu_torch.transformer.pipeline_parallel.utils import param_tree

__all__ = [
    "get_forward_backward_func",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "pipelined_apply",
]


def _record_schedule_metrics(num_microbatches: int, ticks: int,
                             useful_ticks: int) -> None:
    """The reference's schedule-shape telemetry, the same values for the
    same ``M``, ``S`` and chunks: ``pipeline/num_microbatches``,
    ``pipeline/ticks`` and the analytic ``pipeline/bubble_fraction``
    (``1 - useful_ticks / ticks``). Nothing without an open collector."""
    _metrics.record("pipeline/num_microbatches", float(num_microbatches),
                    reduce="mean")
    _metrics.record("pipeline/ticks", float(ticks), reduce="mean")
    _metrics.record("pipeline/bubble_fraction",
                    1.0 - useful_ticks / ticks, reduce="mean")


def _num_micro(batch: Any) -> int:
    return tree_leaves(batch)[0].shape[0]


def _microbatch(batch: Any, m: int) -> Any:
    return tree_map(lambda v: v[m], batch)


def _fp32_zeros(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]


# ---------------------------------------------------------------------------
# no pipelining: microbatches in order, grads accumulated
# ---------------------------------------------------------------------------

def forward_backward_no_pipelining(
    forward_step_func: Callable,
    batch: Any,
    params: Any,
    *,
    forward_only: bool = False,
    grad_scale: Any = 1.0,
    loss_fn: Optional[Callable] = None,
    num_model_chunks: Optional[int] = None,
    remat: Any = False,
) -> Tuple[torch.Tensor, Any]:
    """Loop over the microbatches and accumulate.

    ``forward_step_func(params, microbatch) -> loss`` (a scalar already
    averaged over the microbatch); ``batch`` a tree whose leaves have a
    leading ``num_microbatches`` axis. Returns ``(mean loss, grads or
    None)``: each microbatch's grads of ``loss * grad_scale``, summed in
    fp32 in order and divided by ``M * grad_scale`` (the grad sync is the
    caller's, once, afterwards).

    With ``loss_fn`` the pipelined call shape is taken instead, so the
    dispatcher's call sites are the same at every pipeline size:
    ``forward_step_func(params, x, stage_index)`` is the whole model (the
    one stage of pp = 1), wrapped by the ``remat`` policy, and
    ``loss_fn(y, m)`` the head; ``num_model_chunks`` must then be None or
    1.
    """
    if loss_fn is not None:
        if num_model_chunks not in (None, 1):
            raise ValueError("pp=1 runs have a single model chunk")
        stage_fn = RematPolicy.resolve(remat).wrap(forward_step_func)

        def step(params, m):
            return loss_fn(stage_fn(params, _microbatch(batch, m), 0), m)
    else:
        def step(params, m):
            return forward_step_func(params, _microbatch(batch, m))

    n_micro = _num_micro(batch)
    # pp = 1: every tick is useful (the pipeline/* keys exist for every
    # schedule)
    _record_schedule_metrics(n_micro, n_micro, n_micro)
    leaves, spec = tree_flatten(param_tree(params))
    acc = None if forward_only else _fp32_zeros(leaves)
    total_loss = None
    for m in range(n_micro):
        if forward_only:
            with torch.no_grad():
                loss = step(params, m)
        else:
            scaled = step(params, m) * grad_scale
            grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.to(torch.float32))
            loss = scaled.detach() / grad_scale
        loss = loss.to(torch.float32)
        total_loss = loss if total_loss is None else total_loss + loss
    mean_loss = total_loss / n_micro
    if forward_only:
        return mean_loss, None
    return mean_loss, spec.unflatten([a / (n_micro * grad_scale)
                                      for a in acc])


# ---------------------------------------------------------------------------
# the pipelined schedules' machinery
# ---------------------------------------------------------------------------

class _Saved:
    """A microbatch in flight on a stage: its input (a leaf that
    requires grad, except on global stage 0), its output and, on the last
    stage, its loss; the graph between them lives as long as this."""
    __slots__ = ("x", "y", "loss")

    def __init__(self, x, y, loss):
        self.x, self.y, self.loss = x, y, loss


class _Run:
    """One schedule call on this rank: the stages it holds, the
    microbatches, the accumulators, and the forward and backward of one
    (chunk, microbatch)."""

    def __init__(self, stage_fn, loss_fn, chunks: List[Any], microbatches,
                 remat, grad_scale, shared_params, embed_fn, train: bool):
        if embed_fn is not None and shared_params is None:
            raise ValueError(
                "embed_fn takes (shared_params, microbatch); pass the "
                "embedding parameters via shared_params so they are "
                "differentiated")
        self.pipe = _Pipe()
        self.S, self.r = self.pipe.size, self.pipe.rank
        self.V = len(chunks)
        self.L = self.S * self.V
        self.M = _num_micro(microbatches)
        self.f = RematPolicy.resolve(remat).wrap(stage_fn)
        self.loss_fn, self.embed_fn = loss_fn, embed_fn
        self.chunks, self.shared = chunks, shared_params
        self.microbatches = microbatches
        self.grad_scale = grad_scale
        self.train = train
        self.chunk_leaves = [tree_flatten(param_tree(p)) for p in chunks]
        self.shared_leaves = (tree_flatten(param_tree(shared_params))
                              if shared_params is not None else ([], None))
        self._like = None
        first = (self.chunk_leaves[0][0] + self.shared_leaves[0]
                 + tree_leaves(microbatches))
        self.device = first[0].device
        if train:
            self.acc = [_fp32_zeros(leaves) for leaves, _ in
                        self.chunk_leaves]
            self.acc_shared = _fp32_zeros(self.shared_leaves[0])
        self.loss_sum = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
        self.outputs: List[torch.Tensor] = []

    # -- the activation every hop carries ----------------------------------
    def _first_input(self, mb):
        if self.embed_fn is None:
            if not isinstance(mb, torch.Tensor):
                raise ValueError(
                    "pytree microbatches require embed_fn to map them to "
                    "the pipelined activation")
            return mb
        if self.shared is None:
            return self.embed_fn(mb)
        return self.embed_fn(self.shared, mb)

    def like(self) -> torch.Tensor:
        """A tensor of the pipelined activation's shape, dtype and device
        (global stage 0's input: every stage keeps it), from the first
        microbatch, on every rank."""
        if self._like is None:
            with torch.no_grad():
                self._like = self._first_input(
                    _microbatch(self.microbatches, 0))
        return self._like

    def stage(self, c: int) -> int:
        return c * self.S + self.r

    # -- one stage's forward and backward ----------------------------------
    def forward(self, c: int, m: int, x: Optional[torch.Tensor]) -> _Saved:
        """Global stage ``c * S + r`` on microbatch ``m``: its input is the
        first-stage input on global stage 0, else ``x`` (received)."""
        g = self.stage(c)
        with torch.set_grad_enabled(self.train):
            if g == 0:
                x = self._first_input(_microbatch(self.microbatches, m))
                if self._like is None:
                    self._like = x.detach()
            elif self.train:
                x = x.requires_grad_(True)
            y = self.f(self.chunks[c], x, g)
            like = self.like()
            if y.dtype != like.dtype:
                y = y.to(like.dtype)
            loss = None
            if g == self.L - 1 and self.loss_fn is not None:
                loss = (self.loss_fn(y, m) if self.shared is None
                        else self.loss_fn(self.shared, y, m))
        if not self.train:
            if loss is not None:
                self.loss_sum = self.loss_sum + loss.to(torch.float32)
            return _Saved(None, y, None)
        return _Saved(x, y, loss)

    def backward(self, c: int, saved: _Saved,
                 dy: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The backward of a microbatch's forward on chunk ``c``: the
        last global stage seeds ``grad_scale / M`` on its loss, the others
        take the next stage's ``dy``. Adds the parameter grads into the
        fp32 accumulators (and the loss into the sum); returns the grad of
        the stage's input (None on global stage 0)."""
        g = self.stage(c)
        leaves = self.chunk_leaves[c][0]
        shared = self.shared_leaves[0]
        inputs = leaves + shared + ([saved.x] if g > 0 else [])
        if g == self.L - 1:
            loss = saved.loss
            seed = (torch.as_tensor(self.grad_scale, dtype=torch.float32,
                                    device=loss.device) / self.M)
            out, grad_out = loss, seed.to(loss.dtype)
            self.loss_sum = self.loss_sum + loss.detach().to(torch.float32)
        else:
            out, grad_out = saved.y, dy
        grads = torch.autograd.grad(out, inputs, grad_out, allow_unused=True)
        for acc, gr in zip(self.acc[c] + self.acc_shared,
                           grads[:len(leaves) + len(shared)]):
            if gr is not None:
                acc.add_(gr.to(torch.float32))
        if g == 0:
            return None
        dx = grads[-1]
        return torch.zeros_like(saved.x) if dx is None else dx

    # -- the stage hops ----------------------------------------------------
    def hop(self, send_to: List[Tuple[torch.Tensor, int]],
            recv_from: List[int]) -> List[torch.Tensor]:
        like = self.like() if recv_from else None
        return exchange_stages(self.pipe, send_to,
                               [(like, p) for p in recv_from])

    # -- results -----------------------------------------------------------
    def mean_loss(self) -> torch.Tensor:
        """The mean over the microbatches, from the last pipeline rank,
        the same on every rank (a sum over the group in which the others
        add zero)."""
        last = self.r == self.S - 1
        loss = (self.loss_sum / self.M if last
                else torch.zeros((), dtype=torch.float32, device=self.device))
        if self.S > 1:
            dist.all_reduce(loss, group=self.pipe.group)
        return loss

    def grads(self):
        """Each chunk's grad tree, then the shared grads summed over the
        pipeline group (None without shared params); all fp32, divided by
        ``grad_scale``."""
        inv = 1.0 / torch.as_tensor(self.grad_scale, dtype=torch.float32,
                                    device=self.device)
        chunks = [spec.unflatten([a * inv for a in acc])
                  for acc, (_, spec) in zip(self.acc, self.chunk_leaves)]
        if self.shared is None:
            return chunks, None
        shared = [a * inv for a in self.acc_shared]
        if self.S > 1:
            works = [dist.all_reduce(g, group=self.pipe.group, async_op=True)
                     for g in shared]
            for work in works:
                work.wait()
        return chunks, self.shared_leaves[1].unflatten(shared)


def _run_1f1b(run: _Run) -> None:
    """Upstream's 1F1B for one chunk a rank (the module's docstring)."""
    S, r, M = run.S, run.r, run.M
    first, last = r == 0, r == S - 1
    prev, nxt = r - 1, r + 1
    warmup = min(S - r - 1, M)
    remaining = M - warmup
    inflight = collections.deque()

    def recv_forward():
        return None if first else run.hop([], [prev])[0]

    for m in range(warmup):
        inflight.append(run.forward(0, m, recv_forward()))
        if not last:
            run.hop([(inflight[-1].y, nxt)], [])
    x = recv_forward() if remaining > 0 else None
    for i in range(remaining):
        inflight.append(run.forward(0, warmup + i, x))
        x = None
        # send_forward_recv_backward
        dy = None if last else run.hop([(inflight[-1].y, nxt)], [nxt])[0]
        dx = run.backward(0, inflight.popleft(), dy)
        if first:
            continue
        if i == remaining - 1:
            run.hop([(dx, prev)], [])
        else:
            # send_backward_recv_forward
            x = run.hop([(dx, prev)], [prev])[0]
    for _ in range(warmup):
        dy = None if last else run.hop([], [nxt])[0]
        dx = run.backward(0, inflight.popleft(), dy)
        if not first:
            run.hop([(dx, prev)], [])


def _run_ticks(run: _Run, backward_at: Optional[int]) -> None:
    """The tick loop: microbatch ``m`` runs forward on global stage
    ``g`` at tick ``m + g`` and backward at tick ``m + backward_at - g``
    (no backward when ``backward_at`` is None). Each tick runs this rank's
    backwards and one hop of their input grads to the previous rank, then
    its forwards and one hop of their outputs to the next rank (the last
    rank's chunk ``c`` feeds the first rank's chunk ``c + 1``). The
    backwards go first so that a tick frees what it is done with before
    it adds a microbatch."""
    S, r, V, L, M = run.S, run.r, run.V, run.L, run.M
    nxt, prev = (r + 1) % S, (r - 1) % S
    ticks = M + L - 1 if backward_at is None else M + backward_at
    act: dict = {}
    cot: dict = {}
    saved: dict = {}
    for t in range(ticks):
        if backward_at is not None:
            sends = []
            for c in range(V):
                g = run.stage(c)
                m = t - backward_at + g
                if 0 <= m < M:
                    dy = None if g == L - 1 else cot.pop(c)
                    dx = run.backward(c, saved.pop((c, m)), dy)
                    if g > 0:
                        sends.append((dx, prev))
            recv = [c for c in range(V) if run.stage(c) < L - 1
                    and 0 <= t + 1 - backward_at + run.stage(c) < M]
            cot.update(zip(recv, run.hop(sends, [nxt] * len(recv))))
        sends = []
        for c in range(V):
            g = run.stage(c)
            m = t - g
            if 0 <= m < M:
                y = run.forward(c, m, act.pop(c, None))
                if run.train:
                    saved[(c, m)] = y
                y = y.y
                if g < L - 1:
                    sends.append((y, nxt))
                elif not run.train:
                    run.outputs.append(y)
        y = None
        recv = [c for c in range(V) if run.stage(c) > 0
                and 0 <= t + 1 - run.stage(c) < M]
        act.update(zip(recv, run.hop(sends, [prev] * len(recv))))


def _pipelined(stage_fn, loss_fn, chunks, batch, remat, grad_scale,
               shared_params, embed_fn, memory_efficient: bool,
               forward_only: bool):
    run = _Run(stage_fn, loss_fn, chunks, batch, remat, grad_scale,
               shared_params, embed_fn, train=not forward_only)
    M, L = run.M, run.L
    if forward_only:
        # the reference's forward pass is pipelined_apply's
        _record_schedule_metrics(M, M + L - 1, M)
        _run_ticks(run, None)
        return run.mean_loss(), None
    if memory_efficient:
        _record_schedule_metrics(M, M + 2 * L - 1, M)
        if run.V == 1:
            _run_1f1b(run)
        else:
            _run_ticks(run, 2 * L - 1)
    else:
        _record_schedule_metrics(M, M + L - 1, M)
        _run_ticks(run, M + 2 * L - 2)
    loss = run.mean_loss()
    chunk_grads, shared_grads = run.grads()
    return loss, chunk_grads, shared_grads


# ---------------------------------------------------------------------------
# the public schedules
# ---------------------------------------------------------------------------

def pipelined_apply(
    stage_fn: Callable,
    stage_params: Any,
    microbatches: Any,
    *,
    num_chunks: int = 1,
    remat: Any = False,
    last_stage_fn: Optional[Callable] = None,
    embed_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Run ``microbatches`` through the virtual pipeline, forward only (no
    grad); returns the final global stage's outputs ``(M, ...)``, the same
    on every rank of the pipeline group.

    - ``stage_fn(chunk_params, x, global_stage) -> y``;
    - ``stage_params``: a sequence of ``num_chunks`` trees, this rank's
      chunks (chunk ``c`` on rank ``d`` is global stage ``c * S + d``);
    - ``microbatches``: ``(M, ...)`` fed to global stage 0; activations
      keep this trailing shape through every stage unless ``embed_fn``
      maps them first;
    - ``last_stage_fn(y, m) -> out``, applied to each final output
      (default the identity);
    - ``embed_fn(microbatch) -> activation``: the first-stage input
      transform (then microbatches may be any tree, such as int tokens).
    """
    if len(stage_params) != num_chunks:
        raise ValueError(f"stage_params holds {len(stage_params)} chunks, "
                         f"num_chunks is {num_chunks}")
    run = _Run(stage_fn, None, list(stage_params), microbatches, remat, 1.0,
               None, embed_fn, train=False)
    M, L = run.M, run.L
    _record_schedule_metrics(M, M + L - 1, M)
    _run_ticks(run, None)
    like = run.like()
    if run.r == run.S - 1:
        outs = torch.stack(run.outputs)
    else:
        outs = torch.zeros((M,) + tuple(like.shape), dtype=like.dtype,
                           device=like.device)
    if run.S > 1:
        # the last rank's outputs, summed with the others' zeros
        dist.all_reduce(outs, group=run.pipe.group)
    if last_stage_fn is not None:
        with torch.no_grad():
            outs = torch.stack([last_stage_fn(outs[m], m) for m in range(M)])
    return outs


def forward_backward_pipelining_without_interleaving(
    forward_step_func: Callable,
    batch: Any,
    params: Any,
    *,
    loss_fn: Callable,
    forward_only: bool = False,
    remat: Any = False,
    grad_scale: Any = 1.0,
    shared_params: Any = None,
    embed_fn: Optional[Callable] = None,
    memory_efficient: bool = True,
):
    """The pipelined schedule with one stage a rank: 1F1B
    (``memory_efficient=True``, at most ``S - r`` microbatches in flight
    on pipeline rank ``r``) or all forwards, then all backwards
    (``memory_efficient=False``).

    ``forward_step_func(stage_params, x, stage_index) -> y`` is the stage
    body; ``loss_fn(final_output, microbatch_index) -> scalar``; ``params``
    this rank's stage (no chunk axis). Returns ``(mean loss, grads)``,
    grads of this rank's stage params; with ``shared_params``/``embed_fn``
    (the pipelined embedding and tied head), ``loss_fn(shared, y, m)`` and
    grads ``(stage grads, shared grads)``, the shared grads summed over
    the pipeline group. ``forward_only`` returns ``(mean loss, None)``.
    ``remat``: a bool (True is ``"full"``), a mode string or a
    :class:`~apex_tpu_torch.remat.RematPolicy`, wrapped around the stage.
    """
    out = _pipelined(forward_step_func, loss_fn, [params], batch, remat,
                     grad_scale, shared_params, embed_fn, memory_efficient,
                     forward_only)
    if forward_only:
        return out
    loss, chunk_grads, shared_grads = out
    if shared_params is None:
        return loss, chunk_grads[0]
    return loss, (chunk_grads[0], shared_grads)


def forward_backward_pipelining_with_interleaving(
    forward_step_func: Callable,
    batch: Any,
    params: Any,
    *,
    loss_fn: Callable,
    num_model_chunks: int,
    forward_only: bool = False,
    remat: Any = False,
    grad_scale: Any = 1.0,
    shared_params: Any = None,
    embed_fn: Optional[Callable] = None,
    memory_efficient: bool = True,
):
    """The interleaved virtual pipeline: ``params`` is a sequence of
    ``num_model_chunks`` trees, chunk ``c`` on pipeline rank ``d`` being
    global stage ``c * S + d``. ``memory_efficient=True`` runs the
    reference's 1F1B ticks (at most ``2(L - c * S) - 1`` microbatches in
    flight on chunk ``c``), ``False`` all forwards, then all backwards.
    Returns ``(mean loss, chunk grads)`` (a list, one tree a chunk), or
    ``(mean loss, (chunk grads, shared grads))`` with shared params."""
    if len(params) != num_model_chunks:
        raise ValueError(f"params holds {len(params)} chunks, "
                         f"num_model_chunks is {num_model_chunks}")
    out = _pipelined(forward_step_func, loss_fn, list(params), batch, remat,
                     grad_scale, shared_params, embed_fn, memory_efficient,
                     forward_only)
    if forward_only:
        return out
    loss, chunk_grads, shared_grads = out
    if shared_params is None:
        return loss, chunk_grads
    return loss, (chunk_grads, shared_grads)


def get_forward_backward_func(
        virtual_pipeline_model_parallel_size: Optional[int],
        pipeline_model_parallel_size: int):
    """The schedule for these sizes (upstream's dispatcher)."""
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            return forward_backward_pipelining_with_interleaving
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining
