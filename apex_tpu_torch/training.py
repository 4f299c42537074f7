"""Training-loop helpers across ranks.

Counterpart of ``apex_tpu/training.py``: :func:`accumulate_gradients`
(gradient accumulation with one data-parallel sync a window) and
:class:`GPTHybridTrainer`, the reference's flagship: GPT trained over a
tensor x pipeline x data mesh from one ``TrainConfig``. The reference's
``resolve_bucket_bytes`` prices buckets with pyprof's roofline tuner
(queue item A7b), so ``ddp_bucket_bytes="auto"`` raises naming it.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

__all__ = ["GPTHybridTrainer", "accumulate_gradients"]


def accumulate_gradients(ddp, loss_fn: Callable, params: Any,
                         microbatches: Any) -> Tuple[torch.Tensor, Any]:
    """``(mean loss, synced grads)`` over a window of microbatches, with
    one :meth:`ddp.sync_gradients
    <apex_tpu_torch.parallel.DistributedDataParallel.sync_gradients>` a
    window (``DistributedDataParallel(delay_allreduce=True)``'s use).

    ``loss_fn(params, microbatch) -> scalar``; ``params`` a tree of leaf
    tensors that require grad; ``microbatches`` a tree of tensors with a
    leading window axis ``K``. Each microbatch's grads
    (``torch.autograd.grad``, unsynced) are summed in order into zeros,
    divided by ``K`` and synced once, as the reference's scan does; the
    loss is this rank's window mean. An empty window (``K == 0``), leaves
    that disagree on ``K``, or a ``ddp.axis_name`` that is not bound
    raise ``ValueError`` before any work.
    """
    from apex_tpu_torch.transformer.parallel_state import resolve_axis

    leading = {leaf.shape[0] for leaf in tree_leaves(microbatches)}
    if len(leading) != 1:
        raise ValueError(
            f"microbatch leaves disagree on the accumulation axis: "
            f"{sorted(leading)}")
    num_micro = leading.pop()
    if num_micro == 0:
        raise ValueError(
            "accumulate_gradients got an empty accumulation window "
            "(num_micro == 0); every microbatch leaf has leading dim 0")
    try:
        resolve_axis(ddp.axis_name)
    except ValueError as e:
        raise ValueError(
            f"accumulate_gradients must run where ddp.axis_name="
            f"{ddp.axis_name!r} is bound; it is not bound here: {e}") from e

    leaves, spec = tree_flatten(params)
    acc = [torch.zeros_like(p, memory_format=torch.contiguous_format)
           for p in leaves]
    loss_sum = None
    for k in range(num_micro):
        mb = tree_map(lambda x: x[k], microbatches)
        loss = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        acc = [a + g for a, g in zip(acc, grads)]
        loss = loss.detach().to(torch.float32)
        loss_sum = loss if loss_sum is None else loss_sum + loss
    mean_grads = spec.unflatten([a / num_micro for a in acc])
    return loss_sum / num_micro, ddp.sync_gradients(mean_grads)


class GPTHybridTrainer:
    """GPT trained over a ``tp x pp x dp`` mesh from one
    :class:`~apex_tpu_torch.config.TrainConfig`, on every rank of the
    installed mesh (:meth:`TrainConfig.initialize_mesh` first)::

        trainer = GPTHybridTrainer(cfg, mesh)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        loss, *state = trainer.train_step(*state, tokens, targets)

    ``tokens``/``targets``: ``(M, dp * mb, seq)`` int tensors, the same on
    every rank; data rank ``d`` trains on columns ``[d * mb, (d + 1) *
    mb)``. A step runs the 1F1B schedule over this rank's stage with the
    vocab-parallel embedding on the first stage and the final LayerNorm,
    tied head and loss on the last, averages the grads over the data
    group (per leaf, or in flat buckets with an int ``ddp_bucket_bytes``),
    reduces the finite flag over the mesh, updates the loss scale
    (:class:`~apex_tpu_torch.transformer.amp.GradScaler`, synced over
    tensor and pipe) and steps the config's optimizer over (stage,
    shared) params with the skip; with ``zero=1`` the optimizer state is
    sharded over the data group and its reduce-scatter is the average.
    The loss returned is averaged over the data group.

    A rank's state is ``(stage, shared, opt_state, loss_scale)``: its
    stage, an ``nn.ModuleList`` of its layers, and the embedding and
    final LayerNorm as an ``nn.ModuleDict``, replicated over the pipeline
    (their grads summed over it); the optimizer's parameter tree is
    ``(dict(stage.named_parameters()), dict(shared.named_parameters()))``.
    The model (:attr:`model`) holds every layer so that a seed gives every
    layout the same weights; the layers of other stages are left on the
    meta device once a state is taken. ``train_step`` updates the state
    in place and returns it (the port's counterpart of the reference's
    donated buffers).

    ``health`` is a :class:`~apex_tpu_torch.observability.health.
    HealthConfig` (default: ``cfg.build_health()``, level "off"). Above
    "off" the watchdog rides :meth:`train_step_with_metrics`: its
    ``health/*`` metrics land in the step's metrics and, at "full", the
    params' agreement across the data replicas is checked
    (``health/params/replica_divergence``); :meth:`train_step` and level
    "off" add nothing.

    Not ported: the donation self-check and ``attribution_report`` (A7b).
    """

    def __init__(self, cfg, mesh=None, init_scale: float = 2.0 ** 8,
                 health=None, device="cuda"):
        from apex_tpu_torch._device import resolve_device
        from apex_tpu_torch.config import _unported
        from apex_tpu_torch.optimizers.distributed_fused import (
            _DistributedFusedBase)
        from apex_tpu_torch.transformer import parallel_state
        from apex_tpu_torch.transformer.amp import GradScaler

        self.health = health if health is not None else cfg.build_health()
        bb = cfg.ddp_bucket_bytes
        if bb == "auto":
            raise _unported(
                'ddp_bucket_bytes="auto" (the reference resolves it with '
                "pyprof's tune_bucket_bytes; pass an int)", "A7b")
        if not (bb is None or isinstance(bb, int)):
            raise ValueError(f'ddp_bucket_bytes must be None, an int, or '
                             f'"auto"; got {bb!r}')
        self.mesh = mesh if mesh is not None else parallel_state.get_mesh()
        self.cfg = cfg
        self.bucket_bytes = bb
        self.pp = cfg.parallel.pipeline_model_parallel_size
        if parallel_state.get_pipeline_model_parallel_world_size() != self.pp:
            raise ValueError(
                f"the installed mesh has "
                f"{parallel_state.get_pipeline_model_parallel_world_size()}"
                f" pipeline ranks, the config {self.pp}")
        self.pp_rank = parallel_state.get_pipeline_model_parallel_rank()
        self.device = resolve_device(device)
        self.model = cfg.build_model(device=self.device)
        # the model wraps each layer of a stage by its remat policy
        self.remat_policy = self.model.remat_policy
        self.opt = cfg.build_optimizer()
        self.is_zero = isinstance(self.opt, _DistributedFusedBase)
        self.scaler = GradScaler(init_scale=init_scale)
        _, self.split_params = self.model.stage_fn(self.pp)

    # -- state ----------------------------------------------------------------
    def _take_state(self):
        """This rank's stage and the shared params, from the model; the
        other stages' layers go to the meta device."""
        stages = self.split_params(self.model)
        for s, layers in enumerate(stages):
            if s != self.pp_rank:
                layers.to("meta")
        shared = nn.ModuleDict({"embedding": self.model.embedding,
                                "final_ln": self.model.final_ln})
        return stages[self.pp_rank], shared

    @staticmethod
    def param_tree(stage, shared) -> Tuple[dict, dict]:
        """The optimizer's parameter tree of a state."""
        return dict(stage.named_parameters()), dict(shared.named_parameters())

    def init_state(self, generator: torch.Generator):
        """``(stage, shared, opt_state, loss_scale)`` of this rank from the
        model's ``init`` with ``generator`` (a CPU generator: every layout
        draws the same weights)."""
        self.model.init(generator)
        return self._new_state()

    def load_state(self, stage_state: dict, shared_state: dict,
                   opt_state: Any = None):
        """This rank's state from its stage and shared state dicts
        (``_bridge.split_pipeline_state``'s names) and, if given, an
        optimizer state (else a fresh one)."""
        stage, shared, fresh, ls = self._new_state()
        with torch.no_grad():
            stage.load_state_dict(stage_state)
            shared.load_state_dict(shared_state)
        if opt_state is None:
            return stage, shared, fresh, ls
        opt_state = tree_map(lambda t: t.to(self.device)
                             if isinstance(t, torch.Tensor) else t,
                             opt_state)
        return stage, shared, opt_state, ls

    def _new_state(self):
        stage, shared = self._take_state()
        opt_state = self.opt.init(self.param_tree(stage, shared))
        return stage, shared, opt_state, self.scaler.init(device=self.device)

    # -- the step ---------------------------------------------------------------
    def train_step(self, stage, shared, opt_state, ls, tokens, targets):
        """One step; returns ``(loss, stage, shared, opt_state, ls)``."""
        return self._step_impl(stage, shared, opt_state, ls, tokens,
                               targets)

    def train_step_with_metrics(self, stage, shared, opt_state, ls, tokens,
                                targets):
        """:meth:`train_step` plus the step's telemetry (``amp/*``,
        ``ddp/*``, ``pipeline/*``, ``optim/*``, ``tp/*``, and ``health/*``
        under the trainer's health policy, active around the collector),
        reduced over every axis of the mesh: ``(loss, stage, shared,
        opt_state, ls, metrics)``. Without a collector :meth:`train_step`
        records nothing."""
        from apex_tpu_torch.observability import health, ingraph
        with health.activate(self.health), ingraph.collecting() as col:
            out = self._step_impl(stage, shared, opt_state, ls, tokens,
                                  targets)
            metrics = col.freeze()
        return out + (ingraph.aggregate(
            metrics, tuple(self.mesh.mesh_dim_names)),)

    def jit_train_step(self, with_metrics: bool = False, donate: bool = True,
                       verify_donation: bool = False) -> Callable:
        """The step as a callable, the reference's jitted step: with
        ``donate`` (the default) it updates the state it is handed in
        place; ``donate=False`` steps a copy and leaves the state handed
        in valid. On the ZeRO path the first call checks the optimizer
        state's bucket grid (``opt.check_state``), as the reference does.
        ``verify_donation`` (the donation self-check) is not ported."""
        from apex_tpu_torch.config import _unported
        if verify_donation:
            raise _unported("verify_donation (the donation self-check of "
                            "the analysis rules)", "A7b")
        fn = self.train_step_with_metrics if with_metrics else self.train_step
        pending = [True] if self.is_zero else []

        def step(stage, shared, opt_state, ls, tokens, targets):
            if pending:
                self.opt.check_state(opt_state)
                pending.clear()
            if not donate:
                stage, shared, opt_state, ls = copy.deepcopy(
                    (stage, shared, opt_state, ls))
            return fn(stage, shared, opt_state, ls, tokens, targets)

        return step

    def attribution_report(self, *args, **kwargs):
        from apex_tpu_torch.config import _unported
        raise _unported("attribution_report (pyprof's per-region step "
                        "attribution)", "A7b")

    def _step_impl(self, stage, shared, opt_state, ls, tokens, targets):
        from apex_tpu_torch.amp.scaler import all_finite
        from apex_tpu_torch.observability import health
        from apex_tpu_torch.parallel.distributed import allreduce_grads
        from apex_tpu_torch.transformer.parallel_state import (DATA_AXIS,
                                                                resolve_axis)
        from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
            forward_backward_pipelining_without_interleaving)

        model, scaler = self.model, self.scaler
        # level "full": the params enter the step the same on every data
        # replica, so any divergence is silent replica corruption
        health.observe_replica_agreement(self.param_tree(stage, shared),
                                         DATA_AXIS, name="params")
        data = resolve_axis(DATA_AXIS)
        dp, dr = dist.get_world_size(data), dist.get_rank(data)
        num_micro, batch, seq = tokens.shape
        mb = batch // dp
        tokens = tokens[:, dr * mb:(dr + 1) * mb].to(self.device)
        targets = targets[:, dr * mb:(dr + 1) * mb].to(self.device)
        # the closures over this data rank's targets
        stage_fn, embed_fn, head_fn, _, _ = model.pipeline_fns(self.pp,
                                                               targets)
        mcfg = model.cfg
        if mcfg.tp_comm_overlap:
            # the stages run the layers without transform(), so the ring
            # telemetry is recorded here: M passes on a (mb, s / tp, h)
            # activation shard
            model.record_tp_overlap(
                (mb, seq // mcfg.tensor_model_parallel_size,
                 mcfg.hidden_size), passes=num_micro)
        loss, grads = forward_backward_pipelining_without_interleaving(
            stage_fn, tokens, stage, loss_fn=head_fn, shared_params=shared,
            embed_fn=embed_fn, grad_scale=ls.loss_scale)
        axes = (*scaler.model_parallel_axes, DATA_AXIS)
        if self.is_zero:
            # the grads are still this data rank's: the skip syncs over
            # data too, and the optimizer's reduce-scatter averages them
            finite = all_finite(grads, axis_names=axes)
        elif self.bucket_bytes is not None:
            # the finite flag from the local grads, synced over the mesh,
            # then the bucketed average
            finite = all_finite(grads, axis_names=axes)
            grads = allreduce_grads(grads, DATA_AXIS,
                                    bucket_bytes=self.bucket_bytes)
        else:
            grads = allreduce_grads(grads, DATA_AXIS)
            finite = scaler.all_finite_synced(grads)
        new_ls = scaler.update(ls, finite)
        self.opt.step(grads, opt_state, self.param_tree(stage, shared),
                      grads_finite=finite)
        if dp > 1:
            dist.all_reduce(loss, group=data)
            loss = loss / dp
        return loss, stage, shared, opt_state, new_ls
