"""Asynchronous checkpointing: the port's ``apex_tpu/elastic/ckpt.py``.

CheckFreq's split of :func:`apex_tpu_torch.checkpoint.save_checkpoint`
into two phases:

1. **snapshot** (:func:`host_snapshot`), on the training thread inside
   the step's cadence: wait for the card, then copy every tensor of the
   state into an owned host tensor. The step loop waits for this only.
   The port's optimizers write parameters and state in place (their
   counterpart of the reference's donated buffers), so the snapshot is a
   copy, never a view or a pinned buffer the next step overwrites;
2. **serialize**, on a background thread: ``save_checkpoint``'s files,
   ``host.json``, the COMMITTED marker (last) and ``keep_last`` pruning.

At most one save is in flight: :meth:`AsyncCheckpointer.save` first
drains the one before and re-raises its failure; ``drain`` does too. A
transient ``OSError`` is retried with bounded exponential backoff,
jittered per host. The threaded path is for a world of one process
(``save_checkpoint``'s barriers must not run on a thread beside the
step's collectives): with a process group of more than one rank pass
``collective=True``, where every rank saves synchronously and never
retries (an asymmetric retry would leave the ranks in different
barriers).

Metrics (the port's host registry): ``ckpt/save_ms`` (histogram,
serialize wall per save), ``ckpt/bytes`` (counter, snapshot bytes handed
to the writer), ``ckpt/inflight`` (gauge, 0/1), ``ckpt/saves`` (counter,
committed saves), ``ckpt/retries`` (counter, transient-error retries).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from apex_tpu_torch import checkpoint as _ckpt
from apex_tpu_torch.observability.registry import (MetricsRegistry,
                                                   get_registry)

__all__ = ["AsyncCheckpointer", "host_snapshot", "owned_copy",
           "snapshot_nbytes"]


def host_snapshot(state: Any) -> Any:
    """``state`` with every tensor copied to an owned CPU tensor, after
    the card has finished the work that produced it: a consistent cut of
    the step it follows, which the next step's in-place writes cannot
    touch. Other leaves pass through."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda
           for t in tree_leaves(state)):
        torch.cuda.synchronize()
    return tree_map(lambda t: t.detach().to("cpu", copy=True)
                    if isinstance(t, torch.Tensor) else t, state)


def owned_copy(state: Any) -> Any:
    """A deep copy of ``state``'s tensors on their own devices: restored
    state that enters an in-place step owns its memory."""
    return tree_map(lambda t: t.detach().clone()
                    if isinstance(t, torch.Tensor) else t, state)


def snapshot_nbytes(snapshot: Any) -> int:
    """Total bytes of the tensors (and numpy arrays) of a snapshot or a
    live state."""
    total = 0
    for leaf in tree_leaves(snapshot):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total


class AsyncCheckpointer:
    """Background writer around :func:`~apex_tpu_torch.checkpoint.save_checkpoint`.

    ::

        ckpt = AsyncCheckpointer(dir, keep_last=3)
        for step in ...:
            state = step_fn(state)
            if step % interval == 0:
                ckpt.save(state, step, host_state={"step": step})
        ckpt.drain()          # join the in-flight save; re-raise failures

    ``fault_hook(step, attempt)`` is called before every serialization
    attempt (the :class:`~apex_tpu_torch.elastic.faults.FaultPlan` injection
    point); an ``OSError`` it raises is treated like a real transient
    filesystem error and retried. ``after_save(step, path)`` runs on the
    writer thread after a successful commit (fault plans use it to tear
    markers; production code normally leaves it unset). ``save_fn``
    overrides the serializer (tests substitute slow/counting stand-ins).

    **Retry backoff**: attempt ``a`` sleeps
    ``min(retry_backoff_cap_s, retry_backoff_s * 2**(a-1))`` scaled by
    ``1 + retry_jitter * u`` with ``u ~ U[0, 1)`` drawn from a
    ``RandomState`` seeded on ``(host_id, step)`` — N hosts retrying a
    flaky shared filesystem in LOCKSTEP are a thundering herd that
    re-breaks it on every attempt; per-host jitter decorrelates them,
    and the host_id seed keeps every test (and every rank's schedule)
    deterministic. ``backoff_s`` is the legacy spelling of
    ``retry_backoff_s``.

    **Collective mode** (``collective=True``): for a process group of
    more than one rank, where ``save_checkpoint``'s barriers must run on
    the step's thread: ``save`` serializes *synchronously*, handing the
    live state straight to the collective
    :func:`~apex_tpu_torch.checkpoint.save_checkpoint` (each rank writes
    what it owns; the COMMITTED protocol is fenced by barriers there).
    The threaded split refuses such a world. The interface
    (save/drain/metrics) is the same in both modes. ``host_id`` defaults
    to :func:`apex_tpu_torch.parallel.multiproc.process_id`, as the
    reference's does.
    Collective saves never retry (``max_retries`` is ignored):
    an asymmetric transient failure would have one rank re-entering the
    begin barrier while its peers wait in the arrays barrier — a gang
    deadlock. A failed collective save raises; recovery is the
    supervisor's gang restart from the last COMMITTED generation.
    """

    def __init__(self, directory: str, *, fp32_on_disk: bool = True,
                 keep_last: Optional[int] = None, max_retries: int = 3,
                 backoff_s: Optional[float] = None,
                 retry_backoff_s: Optional[float] = None,
                 retry_backoff_cap_s: Optional[float] = None,
                 retry_jitter: float = 0.25,
                 host_id: Optional[int] = None,
                 collective: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 fault_hook: Optional[Callable[[int, int], None]] = None,
                 after_save: Optional[Callable[[int, str], None]] = None,
                 save_fn: Optional[Callable[..., str]] = None):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if (backoff_s is not None and retry_backoff_s is not None
                and backoff_s != retry_backoff_s):
            raise ValueError(
                f"backoff_s={backoff_s} and retry_backoff_s="
                f"{retry_backoff_s} are the same parameter spelled "
                f"twice; pass only retry_backoff_s")
        if retry_backoff_s is None:
            retry_backoff_s = 0.05 if backoff_s is None else backoff_s
        if retry_backoff_cap_s is None:
            # the default cap must not invalidate a legal base — a
            # legacy backoff_s=60.0 predates the cap and keeps working
            retry_backoff_cap_s = max(30.0, retry_backoff_s)
        elif retry_backoff_cap_s < retry_backoff_s:
            raise ValueError(
                f"retry_backoff_cap_s={retry_backoff_cap_s} below the "
                f"base retry_backoff_s={retry_backoff_s}")
        if retry_jitter < 0.0:
            raise ValueError("retry_jitter must be >= 0")
        self.directory = directory
        self.fp32_on_disk = fp32_on_disk
        self.keep_last = keep_last
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        self.retry_jitter = retry_jitter
        if host_id is None:
            from apex_tpu_torch.parallel.multiproc import process_id
            host_id = process_id()
        self.host_id = int(host_id)
        self.collective = collective
        self.fault_hook = fault_hook
        self.after_save = after_save
        self._save_fn = save_fn or _ckpt.save_checkpoint
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved_step: Optional[int] = None
        reg = registry if registry is not None else get_registry()
        self._m_save_ms = reg.histogram("ckpt/save_ms")
        self._m_bytes = reg.counter("ckpt/bytes")
        self._m_inflight = reg.gauge("ckpt/inflight")
        self._m_saves = reg.counter("ckpt/saves")
        self._m_retries = reg.counter("ckpt/retries")
        self._m_inflight.set(0)

    @property
    def backoff_s(self) -> float:
        """Legacy alias of ``retry_backoff_s``."""
        return self.retry_backoff_s

    def _backoff_sleep_s(self, step: int, attempt: int) -> float:
        """Deterministic jittered backoff before retry ``attempt``
        (1-based) of the save at ``step``."""
        base = min(self.retry_backoff_cap_s,
                   self.retry_backoff_s * (2.0 ** (attempt - 1)))
        if self.retry_jitter <= 0.0:
            return base
        rs = np.random.RandomState(
            (self.host_id * 1_000_003 + step * 7919 + 1) % (2 ** 32))
        u = float(rs.uniform(0.0, 1.0, size=attempt)[-1])
        return base * (1.0 + self.retry_jitter * u)

    # -- writer side ------------------------------------------------------
    def _serialize(self, snapshot: Any, step: int,
                   host_state: Optional[Dict[str, Any]]) -> None:
        last: Optional[BaseException] = None
        # collective mode NEVER retries: the collective save is fenced
        # by named cross-process barriers, and an ASYMMETRIC transient
        # failure (one rank errors out of its write while its
        # peers sit in the arrays-durable barrier) would have the
        # retrying rank re-enter the begin barrier while the others wait
        # in a different one — a gang deadlock the supervisor can only
        # break by teardown. Fail the save loudly instead; multi-host
        # recovery is the supervisor's restart-from-last-COMMITTED, not
        # an in-process retry. (Per-host retry-with-jitter remains the
        # single-controller path's tool.)
        retry_budget = 0 if self.collective else self.max_retries
        for attempt in range(retry_budget + 1):
            if attempt:
                # bounded exponential backoff between transient
                # failures, host-decorrelated by deterministic jitter
                time.sleep(self._backoff_sleep_s(step, attempt))
                self._m_retries.inc()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step, attempt)
                t0 = time.perf_counter()
                path = self._save_fn(
                    self.directory, snapshot, step,
                    fp32_on_disk=self.fp32_on_disk,
                    host_state=host_state, keep_last=self.keep_last)
                self._m_save_ms.observe((time.perf_counter() - t0) * 1e3)
                self._m_saves.inc()
                self.last_saved_step = step
                if self.after_save is not None:
                    self.after_save(step, path)
                return
            except OSError as e:  # transient class: retry with backoff
                last = e
        raise OSError(
            f"checkpoint save at step {step} failed after "
            f"{retry_budget + 1} attempt(s)"
            + (" (collective saves never retry — an asymmetric retry "
               "would deadlock the barrier protocol; recovery is the "
               "supervisor's restart from the last COMMITTED "
               "checkpoint)" if self.collective else "")) from last

    def _run(self, snapshot: Any, step: int,
             host_state: Optional[Dict[str, Any]]) -> None:
        try:
            self._serialize(snapshot, step, host_state)
        except BaseException as e:  # latched; re-raised on next save/drain
            self._error = e
        finally:
            self._m_inflight.set(0)

    # -- trainer side -----------------------------------------------------
    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def save(self, state: Any, step: int, *,
             host_state: Optional[Dict[str, Any]] = None,
             block: bool = False) -> None:
        """Snapshot ``state`` now; serialize it in the background.

        Drains (and error-checks) the previous save first, so at most one
        write is in flight and a failure surfaces within one save
        interval. ``block=True`` additionally waits for THIS save (the
        final/preemption save path).

        In ``collective`` mode the save is synchronous and collective:
        no snapshot and no thread (every rank must be inside the save and
        its barriers at the same time); the live state goes straight to
        the serializer and this call returns only after COMMITTED is
        visible. Without it, a process group of more than one rank
        raises ``ValueError``.
        """
        if self.collective:
            self._m_bytes.inc(snapshot_nbytes(state))
            self._serialize(state, step, host_state)
            return
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise ValueError(
                "AsyncCheckpointer: a process group of "
                f"{dist.get_world_size()} ranks needs collective=True "
                "(the save's barriers cannot run on the writer thread)")
        self.drain()
        snapshot = host_snapshot(state)
        self._m_bytes.inc(snapshot_nbytes(snapshot))
        self._m_inflight.set(1)
        self._thread = threading.Thread(
            target=self._run, args=(snapshot, step, host_state),
            name=f"ckpt-writer-step{step}", daemon=True)
        self._thread.start()
        if block:
            self.drain()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Join the in-flight save (no-op when idle) and re-raise any
        latched writer failure. Call before exiting — a preemption must
        drain, not abandon, the write in progress."""
        th = self._thread
        if th is not None:
            th.join(timeout)
            if th.is_alive():
                raise TimeoutError(
                    f"in-flight checkpoint save did not finish within "
                    f"{timeout}s")
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    close = drain

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.drain()
        else:  # already unwinding: don't mask the primary exception
            try:
                self.drain()
            except Exception:
                pass
