"""Preemption-safe elastic run loop: the port's ``apex_tpu/elastic/runner.py``.

:class:`ElasticRunner` owns the training loop of a
:class:`~apex_tpu_torch.training.GPTHybridTrainer`: periodic
asynchronous checkpoints (:class:`~apex_tpu_torch.elastic.ckpt.
AsyncCheckpointer`), termination through
:class:`~apex_tpu_torch.utils.AutoResume` (SIGTERM, the env var, a hook),
drain-then-save inside the preemption's grace window, and a
deterministic restart: the latest COMMITTED checkpoint (params, optimizer
state with ZeRO's ``bucket_stamp``-guarded flat shards, the loss scale),
the data iterator seeked to the sidecar's cursor, and on. The contract::

    N steps + preempt + restore + M steps  ==  N+M straight steps,

bit for bit, for params, optimizer state, loss scale and data cursor.

The trainer protocol is ``GPTHybridTrainer``'s: ``init_state(generator)
-> state tuple`` and ``jit_train_step() -> fn(*state, *batch) -> (loss,
*state)``; the data protocol is ``next(data) -> batch tuple`` with
``state_dict()`` / ``load_state_dict()`` (:mod:`apex_tpu_torch.elastic.
data`). The port's trainer state holds its stage and shared layers as
``nn.Module``\\ s, updated in place: the checkpoint holds each module's
``state_dict()`` in its place in the tuple, and a restore loads it back
into the live module, so the objects the loop steps stay the same.

Process exits are two: ``AutoResume.request_resume`` (this runner's
preemption) and ``launch._supervisor_exit`` (the supervisor CLI); every
other failure raises, so a scheduler can tell it from a clean
preemption.

In a world of several processes (a ``torch.distributed`` group of more
than one rank) saves are synchronous and collective
(``AsyncCheckpointer(collective=True)``), and the termination poll is an
OR over the world (:func:`apex_tpu_torch.parallel.multiproc.any_process`)
so every rank drains at the same step. A restart into another data
group size reshards ZeRO's flat shards through
:mod:`apex_tpu_torch.elastic.reshard`; a change of the model axes (pipe,
tensor, context) raises.

Metrics (host registry): ``resume/restore_ms``, ``resume/restored_step``
(gauges), ``resume/resumes``, ``resume/reshards``,
``resume/preempt_exits``, ``train/steps`` (counters), and the ``ckpt/*``
family of the checkpointer. A
:class:`~apex_tpu_torch.observability.fleet.FleetPublisher` passed as
``publisher`` snapshots the registry once a step and once more, forced,
on both exits.

``fit(no_recompile=True)`` (the reference's recompile guard) raises
naming queue item A7b, as ``GPTHybridTrainer.jit_train_step`` does for
the donation check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal as _signal
import threading
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_leaves

from apex_tpu_torch import checkpoint as _ckpt
from apex_tpu_torch.elastic.ckpt import AsyncCheckpointer
from apex_tpu_torch.elastic.faults import FaultPlan
from apex_tpu_torch.observability.registry import (MetricsRegistry,
                                                   get_registry)
from apex_tpu_torch.utils.autoresume import AutoResume

__all__ = ["DrainInterrupt", "ElasticRunner", "FitResult"]


class DrainInterrupt(KeyboardInterrupt):
    """A second SIGTERM/SIGINT arrived while the preemption drain was
    writing the final checkpoint. Raised from the signal handler so the
    drain stops at once: a stuck save must not make the job unkillable.
    A :class:`KeyboardInterrupt`, so no ``except Exception`` on the way
    out swallows it. The abandoned checkpoint is at worst torn
    (COMMITTED is written last), so the previous COMMITTED step stays the
    restore point."""


@contextlib.contextmanager
def _second_signal_escalation():
    """Two-signal semantics for the drain: the first SIGTERM/SIGINT asked
    for the drain now running; a second one during it raises
    :class:`DrainInterrupt` instead of latching. Installed only around
    the drain and only on the main thread (the one that receives
    signals); the previous handlers come back on the way out."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def escalate(signum, frame):
        raise DrainInterrupt(
            f"second termination signal "
            f"({_signal.Signals(signum).name}) during the preemption "
            f"drain — aborting the in-flight save so the job stays "
            f"killable; the previous COMMITTED checkpoint remains the "
            f"restore point")

    prev = {s: _signal.signal(s, escalate)
            for s in (_signal.SIGTERM, _signal.SIGINT)}
    try:
        yield
    finally:
        for s, h in prev.items():
            _signal.signal(s, h)


@dataclasses.dataclass
class FitResult:
    """What a (possibly interrupted) :meth:`ElasticRunner.fit` produced."""

    state: Any                    # trainer state tuple after the last step
    step: int                     # completed steps
    loss: Optional[float]         # last step's loss (None if no step ran)
    preempted: bool               # True: stopped on a termination request
    restored_from: Optional[int]  # checkpoint step this run resumed from
    resharded: bool = False       # restore crossed a world-size change


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _tree(state: tuple) -> tuple:
    """The checkpoint tree of a state: each module by its
    ``state_dict()``, every other element as it is."""
    return tuple(x.state_dict() if isinstance(x, nn.Module) else x
                 for x in state)


def _untree(state: tuple, tree: tuple) -> tuple:
    """``state`` with ``tree`` (restored from :func:`_tree`'s layout)
    loaded: modules in place, every other element replaced."""
    out = []
    with torch.no_grad():
        for live, saved in zip(state, tree):
            if isinstance(live, nn.Module):
                live.load_state_dict(saved)
                out.append(live)
            else:
                out.append(saved)
    return tuple(out)


class ElasticRunner:
    """Elastic training loop: checkpoint cadence and preemption handling.

    ``directory`` is the checkpoint root. ``save_interval=K`` saves every
    K completed steps (asynchronously in a world of one process);
    ``keep_last`` bounds the generations on disk. ``fault_plan`` wires a
    :class:`~apex_tpu_torch.elastic.faults.FaultPlan` into the loop and
    the checkpointer. ``exit_on_preempt=False`` makes a preemption return
    ``FitResult(preempted=True)`` instead of calling
    ``AutoResume.request_resume`` (in-process runs; production keeps the
    exit-0-and-the-scheduler-restarts default). ``publisher`` attaches a
    :class:`~apex_tpu_torch.observability.fleet.FleetPublisher`.
    """

    def __init__(self, trainer: Any, data: Any, directory: str, *,
                 save_interval: int = 50, keep_last: Optional[int] = 3,
                 fp32_on_disk: bool = True,
                 autoresume: Optional[AutoResume] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 registry: Optional[MetricsRegistry] = None,
                 exit_on_preempt: bool = True, final_save: bool = True,
                 on_step: Optional[Callable[[int, Any], None]] = None,
                 checkpointer: Optional[AsyncCheckpointer] = None,
                 publisher: Optional[Any] = None):
        if save_interval < 1:
            raise ValueError("save_interval must be >= 1")
        self.trainer = trainer
        self.data = data
        self.directory = directory
        self.save_interval = save_interval
        self.fault_plan = fault_plan
        self.autoresume = autoresume
        self.exit_on_preempt = exit_on_preempt
        self.final_save = final_save
        self.on_step = on_step
        self.publisher = publisher
        self._registry = (registry if registry is not None
                          else get_registry())
        # the fleet snapshot's completed-step counter: host-side, the loss
        # is not read back each step
        self._m_steps = self._registry.counter("train/steps")
        # several processes checkpoint collectively and synchronously (the
        # save's barriers cannot run on the writer thread)
        self._multiprocess = _world_size() > 1
        self.ckpt = checkpointer if checkpointer is not None else \
            AsyncCheckpointer(
                directory, fp32_on_disk=fp32_on_disk, keep_last=keep_last,
                registry=self._registry, collective=self._multiprocess,
                fault_hook=(fault_plan.on_save_attempt if fault_plan
                            else None),
                after_save=(fault_plan.after_save if fault_plan else None))

    # -- sidecar ----------------------------------------------------------
    def _world_meta(self) -> Optional[dict]:
        """The world this trainer's checkpoints are laid out for, in the
        sidecar, so a restart into another world takes the reshard path
        instead of a silent mis-restore. ``None`` for a trainer without a
        mesh (its layout does not depend on the world)."""
        mesh = getattr(self.trainer, "mesh", None)
        if mesh is None:
            return None
        shape = dict(zip(mesh.mesh_dim_names,
                         (int(n) for n in mesh.mesh.shape)))
        from apex_tpu_torch.parallel.multiproc import process_count
        meta = {"dp": int(shape.get("data", 1)),
                "pp": int(shape.get("pipe", 1)),
                "tp": int(shape.get("tensor", 1)),
                "cp": int(shape.get("context", 1)),
                "num_hosts": int(process_count())}
        if getattr(self.trainer, "is_zero", False):
            lay = getattr(getattr(self.trainer, "opt", None), "_layout",
                          None)
            if lay is not None:
                meta["flat_total"] = int(lay.total)
                meta["bucket_bytes"] = int(
                    getattr(self.trainer.opt, "bucket_bytes", None) or 0)
        return meta

    def _host_state(self, step: int) -> dict:
        host = {"step": int(step)}
        if self.data is not None and hasattr(self.data, "state_dict"):
            host["data"] = self.data.state_dict()
        world = self._world_meta()
        if world is not None:
            host["world"] = world
        return host

    def _save(self, state: tuple, step: int, block: bool = False) -> None:
        self.ckpt.save(_tree(state), step,
                       host_state=self._host_state(step), block=block)

    # -- restore ----------------------------------------------------------
    def _load_data_cursor(self, host: dict) -> None:
        """Seek the data iterator to the sidecar's cursor. A cursor saved
        under another host grid takes ``reseek`` (the global sequence is
        kept, the per-host slices follow the new grid); the same grid
        keeps ``load_state_dict``'s checks."""
        if (self.data is None or "data" not in host
                or not hasattr(self.data, "load_state_dict")):
            return
        dstate = host["data"]
        saved_hosts = (dstate.get("num_hosts")
                       if isinstance(dstate, dict) else None)
        cur_hosts = getattr(self.data, "num_hosts", None)
        if (saved_hosts is not None and cur_hosts is not None
                and int(saved_hosts) != int(cur_hosts)
                and hasattr(self.data, "reseek")):
            self.data.reseek(dstate)
        else:
            self.data.load_state_dict(dstate)

    def _restore_resharded(self, state: tuple, saved: dict,
                           cur: dict) -> tuple:
        """Restore across a data group size change: the checkpoint's ZeRO
        flat shards were laid out for ``saved['dp']``; read them whole
        (the ranks' shards concatenated), re-partition them for
        ``cur['dp']`` and keep this rank's shard. Only the data axis may
        change (the model axes are refused in :meth:`_restore`). Returns
        ``(restored, host)``."""
        from apex_tpu_torch.elastic import reshard as _reshard

        opt_state = state[2]
        if not (hasattr(opt_state, "master")
                and hasattr(opt_state, "bucket_stamp")):
            raise ValueError(
                f"world size changed (saved dp={saved['dp']}, live "
                f"dp={cur['dp']}) but the optimizer state "
                f"({type(opt_state).__name__}) is not a ZeRO flat-shard "
                f"state this runner knows how to reshard")
        if "flat_total" not in saved:
            raise ValueError(
                f"world size changed (saved dp={saved['dp']}, live "
                f"dp={cur['dp']}) but the checkpoint sidecar carries no "
                f"flat_total — it was not written by a ZeRO trainer, so "
                f"there is no flat-shard layout to reshard")
        total = int(saved["flat_total"])
        bb_old = int(saved.get("bucket_bytes", 0)) or None
        bb_new = int(getattr(self.trainer.opt, "bucket_bytes", None)
                     or 0) or None
        pp, tp = int(saved["pp"]), int(saved["tp"])
        dp_old, dp_new = int(saved["dp"]), int(cur["dp"])
        padded_old, _ = _reshard.flat_grid(total, dp_old, bb_old)
        padded_new, _ = _reshard.flat_grid(total, dp_new, bb_new)
        # a target shaped like the whole reads every rank's shard (a meta
        # tensor: the concatenation lands on the host)
        whole = torch.empty(pp * tp * padded_old, dtype=torch.float32,
                            device="meta")
        tree = _tree(state)
        target = (*tree[:2], opt_state._replace(
            master=whole, exp_avg=whole, exp_avg_sq=whole), *tree[3:])
        restored, host = _ckpt.restore_checkpoint(self.directory, target)
        ropt = _reshard.reshard_zero_state(
            restored[2], total=total, dp_old=dp_old, dp_new=dp_new,
            bucket_bytes=bb_old, bucket_bytes_new=bb_new, pp=pp, tp=tp)
        # this rank's shard of each new global vector, in (pipe, data,
        # tensor) order, on the live shard's device
        index, sizes = _ckpt._grid()
        chunk = padded_new // dp_new
        at = _ckpt._zero_index(index, sizes) * chunk

        def mine(whole_new, live):
            return whole_new[at:at + chunk].to(live.device).clone()

        new_opt = restored[2]._replace(
            master=mine(ropt.master, opt_state.master),
            exp_avg=mine(ropt.exp_avg, opt_state.exp_avg),
            exp_avg_sq=mine(ropt.exp_avg_sq, opt_state.exp_avg_sq))
        if (bb_old or 0) != (bb_new or 0):
            # the reshard re-bucketed the shards for the new grid; the
            # stamp now certifies that layout (check_state validates it
            # at the step)
            new_opt = new_opt._replace(bucket_stamp=int(bb_new or 0))
        self._registry.counter("resume/reshards").inc()
        return (*restored[:2], new_opt, *restored[3:]), host

    def _restore(self, state: tuple) -> tuple:
        """Latest-COMMITTED restore onto the live state; returns
        ``(state, completed_steps, restored_from, resharded)``."""
        latest = _ckpt.latest_step(self.directory)
        if latest is None:
            # still warn about torn dirs a dead writer left behind
            torn = _ckpt.torn_steps(self.directory)
            if torn:
                import warnings
                warnings.warn(
                    f"no committed checkpoint under {self.directory!r}; "
                    f"ignoring torn dir(s) at step(s) {torn} and starting "
                    "from scratch")
            return state, 0, None, False
        t0 = time.perf_counter()
        # the saved world first: ZeRO's flat shards on disk are shaped by
        # the OLD data group
        _, peek = _ckpt.read_host_state(self.directory, latest)
        saved_world, cur_world = peek.get("world"), self._world_meta()
        resharded = False
        if (saved_world is not None and cur_world is not None
                and any(int(saved_world.get(k, cur_world[k]))
                        != cur_world[k] for k in ("pp", "tp", "cp"))):
            raise ValueError(
                f"checkpoint was saved on a pp={saved_world.get('pp')} x "
                f"tp={saved_world.get('tp')} x "
                f"cp={saved_world.get('cp')} grid but this trainer runs "
                f"pp={cur_world['pp']} x tp={cur_world['tp']} x "
                f"cp={cur_world['cp']}; only the data axis is elastic — "
                f"model-axis resharding needs the partition-rule engine")
        if (saved_world is not None and cur_world is not None
                and int(saved_world.get("dp", cur_world["dp"]))
                != cur_world["dp"]
                and getattr(self.trainer, "is_zero", False)):
            tree, host = self._restore_resharded(state, saved_world,
                                                 cur_world)
            resharded = True
        else:
            # params and replicated leaves do not depend on dp, so a dp
            # change without ZeRO state restores them as they are
            tree, host = _ckpt.restore_checkpoint(self.directory,
                                                  _tree(state))
        restored = _untree(state, tree)
        if any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in tree_leaves(tree)):
            torch.cuda.synchronize()
        self._registry.gauge("resume/restore_ms").set(
            (time.perf_counter() - t0) * 1e3)
        step = int(host.get("step", latest))
        self._registry.gauge("resume/restored_step").set(step)
        self._registry.counter("resume/resumes").inc()
        self._load_data_cursor(host)
        # the restored step is on disk: mark it saved, so a fit that runs
        # no further step does not save it again (save_checkpoint clears
        # the directory first, and a kill then would destroy the newest
        # COMMITTED step). A resharded restore saves again at the next
        # interval: the step on disk belongs to the old world.
        if not resharded:
            self.ckpt.last_saved_step = step
        # the restored tensors are fresh (read from disk, or copied into
        # the live modules): an in-place step cannot alias them
        return restored, step, step, resharded

    # -- preemption -------------------------------------------------------
    def _preempt(self, ar: AutoResume, state: tuple, step: int,
                 loss: Any, restored_from: Optional[int],
                 resharded: bool = False) -> FitResult:
        """The grace-window path: drain the in-flight save, write a final
        checkpoint at the current step, then hand control back to the
        scheduler (exit 0 through ``request_resume``). A second signal
        during the drain raises :class:`DrainInterrupt`."""
        with _second_signal_escalation():
            self.ckpt.drain()
            if self.ckpt.last_saved_step != step:
                self._save(state, step, block=True)
        self._registry.counter("resume/preempt_exits").inc()
        if self.publisher is not None:
            # the final snapshot must beat the exit: the supervisor's
            # postmortem reads it after this process is gone
            self.publisher.publish(step, force=True)
        if self.exit_on_preempt:
            ar.request_resume()  # sys.exit(0): scheduler restarts the job
        return FitResult(state=state, step=step,
                         loss=None if loss is None else float(loss),
                         preempted=True, restored_from=restored_from,
                         resharded=resharded)

    # -- the loop ---------------------------------------------------------
    def fit(self, steps: int, *, generator: Optional[torch.Generator] = None,
            state: Optional[tuple] = None,
            no_recompile: bool = False) -> FitResult:
        """Run until ``steps`` steps are COMPLETED (the restored prefix
        counted), checkpointing on the way. ``state`` overrides the fresh
        ``trainer.init_state(generator)`` (default a CPU generator seeded
        0) used as the restore target."""
        if no_recompile:
            from apex_tpu_torch.config import _unported
            raise _unported("fit(no_recompile=True) (the recompile guard "
                            "of the analysis rules)", "A7b")
        if state is None:
            state = self.trainer.init_state(
                generator if generator is not None
                else torch.Generator().manual_seed(0))
        state, step, restored_from, resharded = self._restore(tuple(state))
        ar = self.autoresume
        own_ar = ar is None
        if own_ar:
            ar = AutoResume(interval=1)
        step_fn = self.trainer.jit_train_step()
        loss = None
        if self._multiprocess:
            from apex_tpu_torch.parallel.multiproc import any_process
        else:
            any_process = bool
        preempted = False
        try:
            while step < steps:
                if self.fault_plan is not None:
                    self.fault_plan.before_step(step)
                # the preemption decision is collective: if any process
                # saw the signal, every process leaves at this step
                if any_process(ar.termination_requested(step)):
                    preempted = True
                    break
                batch = next(self.data)
                loss, *state = step_fn(*state, *batch)
                state = tuple(state)
                step += 1
                self._m_steps.inc()
                if self.publisher is not None:
                    self.publisher.publish(step)
                if self.on_step is not None:
                    self.on_step(step, loss)
                if step % self.save_interval == 0 and step < steps:
                    self._save(state, step)
            if preempted:
                return self._preempt(ar, state, step, loss,
                                     restored_from, resharded)
            # run complete: drain the tail save, then commit the final one
            self.ckpt.drain()
            if any_process(ar.termination_requested(step)):
                return self._preempt(ar, state, step, loss, restored_from,
                                     resharded)
            if self.final_save and self.ckpt.last_saved_step != step:
                self._save(state, step, block=True)
            if self.publisher is not None:
                self.publisher.publish(step, force=True)
            return FitResult(state=state, step=step,
                             loss=None if loss is None else float(loss),
                             preempted=False, restored_from=restored_from,
                             resharded=resharded)
        finally:
            if own_ar:
                ar.close()
